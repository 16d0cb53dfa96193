#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``futuresdr_tpu_torch``) on one GPU.

Drives the port's main path, the north-star spectrum chain (complex64 frames
through a 64-tap FIR, a 2048-point FFT and |x|^2), through the entry points a
user calls, at full width:

1. the card's name and power limit (``nvidia-smi``);
2. the kernels' build from ``futuresdr_tpu_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version on the card, at the path's
   shapes and at ragged ones, f32 and bf16, and at the edges of the
   ``fir``, ``fir_fft``, ``poly_fir`` and ``pfb`` tiling plans
   (``ops/cuda_kernels.py``);
4. the device-resident chain in three routes (overlap-save FIR,
   ``fir_stage(impl="pallas")`` on the ``fir`` kernel, ``fir_fft_stage`` on
   the ``fir_fft`` kernel) at frames 2^18 and 2^20, carry chained over 8
   frames: the kernel routes match overlap-save, and 8 chained frames match
   one long frame;
5. the streamed flowgraph, ``NullSource -> Head -> TpuKernel -> NullSink``
   with 4 frames in flight, and ``VectorSource -> TpuKernel -> VectorSink``
   against the resident chain;
6. a tap retune mid-stream through ``TpuKernel.apply_retune``;
7. one JSON line with each kernel's launches on its path (the spectrum chain
   in phases 4-6, the FM front end in phases 10-11), its error against the
   plain version, and its time beside the plain version's, a PyTorch library
   call's and its bound; each timing line also shows the call's time in
   PERF.md before the kernel's latest redesign, and for ``rotator`` and
   ``quad_demod`` two yardsticks: a kernel with no body on the same grid and
   a PyTorch copy of the same bytes;
8. the resident and streamed rate of each route beside the card.

The FM front end (``futuresdr_tpu_torch/apps/fm_receiver.py``: complex64 at
1 Msps, 100 kHz offset, 128-tap channel filter decimating by 4, FM gain
250e3/(2π·75e3), 24/125 audio resampler with its 4533 default taps), in two
chains: the app's (``front_end_stages``: xlating FIR, demod, resampler) and
the kernel chain (``rotator_stage``, ``fir_stage(decim=4)``,
``quad_demod_stage``, ``resample_stage``, each pinned to ``impl="pallas"``):

9. the ``rotator``, ``poly_fir`` and ``quad_demod`` kernels against their
   plain versions at the FM shapes, ragged ones, large phases and bf16; the
   views ``x[1:]`` (a head sample before the first 16-byte word) and
   ``x[:-1]``, 1-3 samples and one block's tile +- 1; the rotator's
   next phase equal to ``torch.remainder`` bit for bit, also beside +-π;
10. both chains resident at frames 512,000 and 4,096,000, carry chained over
    8 frames: the kernel chain matches the same chain on plain PyTorch ops,
    chained frames match one long frame, and the app chain matches the
    kernel chain after the filters' transient;
11. streamed: ``NullSource -> Head -> TpuKernel -> NullSink`` with 4 frames in
    flight per chain, ``build_flowgraph(VectorSource(fm), use_tpu=True,
    audio_path=…)`` with the WAV's tone at 1 kHz, and a mid-stream
    ``apply_retune("tuner", phase_inc=…)`` on both chains; then the kernels
    one resident frame of the kernel chain launches, by ``torch.profiler``,
    and of its ``rotator_stage`` alone, which must be one.

The PFB channelizer at PFB-64 (``channelizer_stage(64)`` with its default
768-tap prototype, K = 12 taps a branch), and the spectrum app:

12. the ``pfb`` kernel against its plain version at PFB-64 (t = 4096, f32 and
    bf16), at ragged t (1 and 37), at N = 5, 24, 1000, 1024, 2048 and 4096
    (from N = 1024 on, the channels staged 512 at a time), at K = 1, and in
    the plan's "v" layout (rows too wide to stage) forced at N = 2048 and
    1000; in bf16 also the kernel run in float32 mode on the same inputs,
    which must fall below the bf16 limit;
13. the channelizer resident on both routes (``matmul``: windows einsum and
    ``torch.fft.ifft``; ``pallas``: the ``pfb`` kernel) at frames 2^18 and
    2^21, carry chained over 8 frames: the routes agree at >= 80 dB, chained
    frames match one long frame, and a tone at channel 3's and channel 40's
    centre lands in its own output; the stage's default ``impl="auto"``
    launches the kernel and gives the ``pallas`` route's output, at PFB-64
    and at PFB-2048 (against ``matmul`` there);
14. streamed: ``NullSource -> Head -> TpuKernel -> NullSink`` with 4 frames in
    flight, ``VectorSource -> TpuKernel -> StreamDeinterleaver(64) -> 64
    VectorSinks`` against the resident chain and the host ``PfbChannelizer``
    block, and a prototype swap mid-stream through ``apply_retune``;
15. the spectrum app, ``apps/spectrum.py`` ``build_flowgraph(VectorSource(…),
    use_tpu=True, collect=True)`` at FFT_SIZE 2048 over 32,768-sample frames:
    the tone's bin, and the spectra against a float64 recomputation.

The host side of the main path (``Pipeline.compile``: one CUDA graph a
dispatch of K frames, the carry in static buffers; ``TpuKernel``'s
megabatch K, pinned staging arena and credits), on every chain above
(spectrum routes, spectrum app, FM app, kernel and plain chains, PFB-64 on
both routes) at the frames of their resident phases:

16. each chain compiled at K = 1 and 4 against the eager chain over three
    chained dispatches (CHAIN_TOL), one capture each, each replay adding
    its graph's launches to the counts; a retune through the compiled carry
    (FIR taps, the FM tuner's phase_inc, the PFB prototype) with no new
    capture, against the eager chain with the same retune; the resident
    rate of eager and compiled beside the card's time a frame;
17. streamed, ``VectorSource -> TpuKernel -> VectorSink`` at K = 4 against
    K = 1 (the same items, a partial last group at EOS), the streamed rate
    at each K, and the arena's takes from its pool against its allocations.

Every streamed phase runs through the compiled program and the arena, and
the ``kernels`` line counts the launches the replays made.

The message plane, the REST control port, the apps' ``main()`` and the
double-mapped circular buffer (``runtime/buffer/circular.py`` over
``csrc/host/ringbuf.cpp``, built with ``g++``; the script fails if it does
not build, so every streamed phase runs on it):

18. ``MessageSource -> MessageCopy -> MessageSink``, then ``handle.call``,
    ``post``, ``describe`` and ``metrics`` against a running streamed
    ``TpuKernel`` (the fused spectrum chain), its taps retuned through its
    ``ctrl`` port;
19. the FM app's card flowgraph (its default) with the Seify dummy radio (its tone at
    0.1·fs), the tuner at 75 kHz moved to 90 kHz by a POST of
    ``{"stage": "tuner", "phase_inc": θ}`` to the REST control port: the
    reply is ``Ok``, each audio frame's mean (the discriminator's DC level)
    is the gain's level for 25 kHz before and 10 kHz after within 2%, a
    malformed map is answered ``InvalidValue``; the round trip and the
    frames from the POST to the first retuned frame are printed;
20. both apps' ``main()`` as subprocesses: the FM receiver on the card (its
    default) with ``--wav`` and ``25000`` then ``q`` on stdin (exit 0, a WAV with audio),
    the spectrum app with ``--samples`` and ``--ws-port`` read by a
    standard-library websocket client (a 2048-float spectrum peaking at the
    dummy tone's bin);
21. the streamed spectrum fused chain at 2^18 and FM kernel chain at 512,000
    on the circular buffer and on the ring: bit-equal outputs, and the
    streamed input rates at K = 1 and 4 on each.

The device-frame plane and device-graph fusion (``tpu/frames.py``,
``runtime/devchain.py``): each region runs fused and per hop
(``FSDR_NO_DEVCHAIN=1``) in this process at K = 1 and 4, ``VectorSource`` in
and ``VectorSink`` out against each other (bit-equal at K = 1, CHAIN_TOL at
K = 4, with the bit-equal cases printed), then streamed from ``NullSource ->
Head`` (64 frames) into ``NullSink``s, median of 3, the modes in turns: the
input rate, program dispatches a frame (the blocks' own counters through the
fused run's metrics bridge) and H2D/D2H bytes a frame (``xfer.bytes_total``):

22. linear, the spectrum chain at 2^18: ``TpuH2D -> TpuStage[fir_stage(impl=
    "pallas")] -> TpuStage[fft_stage(2048)] -> TpuStage[mag2_stage()] ->
    TpuD2H`` (3 dispatches a frame per hop, 1 fused) and ``TpuKernel[
    fir_fft_stage] -> TpuKernel[mag2_stage]`` over a stream edge (2 → 1);
23. fan-out, the FM front end at 512,000 a frame: a ``TpuKernel`` over the
    kernel chain's rotator, decim-4 channel filter and demod, broadcast to
    ``TpuKernel[resample_stage(24, 125, impl="pallas")]`` and
    ``TpuKernel[mag2_stage()]`` (3 → 1; H2D 4,096,000 B a frame fused,
    5,120,000 per hop);
24. DAG at 512,000 a frame: ``TpuH2D`` broadcast into two decim-4 FIR stages
    (``lowpass(0.1, 128)``, ``lowpass(0.05, 128)``, ``impl="pallas"``) joined
    by ``TpuMergeStage(add_merge_stage(2), [mag2_stage()])`` into ``TpuD2H``,
    and the stream-plane nested fan-out ``prod -> {a -> {c, d}, b}`` of
    ``TpuKernel``s (1 dispatch a frame fused; D2H only the sinks' payloads).

The wires (``ops/wire.py``; the phases above pin the f32 wire, ``LINK``,
where their checks were set for a float32 link; on a card the default is
sc16, which the apps' phases 19-20 keep):

25. (a) each wire's device decode and encode against its host twin, bit for
    bit, at 2^18 and 512,000 complex64 and a float32 frame, with non-finite
    samples and an all-zero frame, and K = 4 frames of different peaks
    through a captured wired program; (b) ``VectorSource -> TpuKernel(wire)
    -> VectorSink`` for f32, bf16, sc16 and sc8 at K = 1 and 4 on the
    spectrum fused chain at 2^18 and the FM kernel chain at 512,000 against
    the resident float32 chain: f32 bit-equal, the others by SNR
    (``WIRE_SNR``); (c) the link bytes a frame against the wire's by
    construction (sc16 at 2^18: 1,048,640 B up, 524,292 down) and one H2D
    start a packed group; (d) ``TpuH2D(sc16) -> TpuStage* -> TpuD2H(sc16)``
    fused bit-equal to per hop, and no fusion where the end wires differ;
    (e) ``apply_wire_retune`` f32 -> sc8 -> f32 mid-stream (every frame out,
    each segment against the chained wired programs, back to the first
    program with no capture) and ``tpu_adaptive_wire`` widening sc8 on a
    burst; (f) zero-copy ingest from a registered, page-locked buffer; (g)
    seeded transient H2D faults retried to the unfaulted output, an
    exhausted budget failing with ``TransferError``; (h) each wire's streamed
    rate at K = 1 and 4 with its measured codec SNR.

Recovery on the streamed path (``runtime/block.py`` ``BlockPolicy``,
``tpu/kernel_block.py``'s carry checkpoint and replay, ``runtime/devchain.py``
fused restarts):

26. (a) the spectrum chain streamed at 2^18 on the ``fused`` (``fir_fft``)
    and ``pallas`` (``fir``) routes and the FM kernel chain at 512,000, each
    at K = 1 and 4 under ``restart`` with ``checkpoint_every`` 1 and 8, with
    a non-transient ``dispatch`` fault, an ``h2d`` fault, and a ``carry``
    fault corrupting the newest checkpoint followed by a ``dispatch`` fault
    (the source held between segments so the two land in that order), each
    mid-stream: the output equals the fault-free run bit for bit, with a
    restart, frames replayed, the corrupted candidate rejected and no new
    capture; (b) phase 22's three-``TpuStage`` region and phase 23's
    fan-out, each with a ``restart`` member, fused, a bare ``dispatch``
    fault: bit-equal to the fault-free fused run; (c) cadence 0 under
    ``restart``: the window is forfeited, counted, and the run completes;
    (d) ``checkpoint_dir`` across two processes of this script
    (``--ckpt-part 1|2``): the second restores from the first's file, the
    outputs together bit-equal to one run, and a corrupted file rejected;
    (e) ``isolate``: a failing FM branch retires and the independent
    spectrum branch equals its solo run; (f) the streamed rate at K = 1 and
    4 with cadence 0, 1 and 8 and no fault, the arena's peak pinned bytes,
    and the time from ``recover()`` to the first replayed output.

27. precision and tuning: (a) the A/B matrix of the JAX package's
    ``perf/precision_ab.py`` (the spectrum chain, on the ``fir`` kernel, fused
    as ``fir_fft``; PFB-64 matmul and pallas; the decimating FIR,
    ``lowpass(0.04, 128)``, D = 16, poly and pallas) at 2^18 in f32, auto
    (40 dB), bf16 and int8 where the row has the rung, resident through
    ``utils/measure.run_marginal``: rates, card µs a frame, each plan's
    SNRs, the lowered program against f32 on fresh frames at the floor
    ``budget - 10·log10(n_lowered)``, ``off`` the same object and bits;
    (b) the int8 rungs on the card bit-equal to the CPU; (c) the plan sweep
    (``tpu/kernel_tune.py``) over all six kernels, every candidate matching
    its plain version, the winners cached, installed by a fresh
    ``TpuKernel`` and taken by the next launch; (d) the credit seed, the
    adaptive wire's start and a fused region's K from the cache; (e) the
    spectrum chain streamed with ``interior_precision="auto"`` at K = 1 and
    4 against f32, and ``ctrl`` retunes off and back mid-stream, one capture
    a program; (f) after phase 7, each kernel's analytic bound
    (``utils/roofline.py``) against PERF.md's within 2% and its share of
    the bound at most 1.05; (g) the spectrum app with ``--bf16`` and
    ``--autotune``.

The serving plane (``serve/engine.py`` ``ServeEngine``: the paged,
lane-batched slot program, one CUDA graph a bucket):

28. (a) the lane forms ``fir_lanes``, ``fir_fft_lanes`` and ``rotator_lanes``
    at L = 1, 4 and 64 with distinct taps, histories and phases: each lane
    bit-equal to the one-stream launch, and within the kernel's tolerance
    of the lane plain version; (b) the main chain (``fir_fft_stage(64 taps,
    2048)`` + ``mag2_stage``) served at 2^18 to 16 sessions in buckets (1, 4,
    16), four of them retuned to their own taps: each session bit-equal to
    the bare compiled ``Pipeline`` on its frames, and N = 1 in the
    capacity-4 bucket too; (c) serve_ab's chain (``rotator_stage(0.013,
    impl="pallas")`` + ``fir_stage(hanning(17), fft_len=128,
    impl="pallas")``) at 512 to 64 sessions with 100 join/leave events: no
    build after the first dispatch, one dispatch a busy frame time, every
    stream, an evict/readmit round trip and a session persisted at
    in-flight depth 3 and resumed by a new engine bit-equal to the bare
    ``Pipeline``; (d) printed, beside the card: ``autotune_serve``'s ladder
    and rates, one dispatch's card time, submit→result p99 under churn, and
    the served sessions against as many independent compiled loops
    (``perf/serve_ab.py``'s A/B); the lane kernels' timings join the
    ``kernels`` line.

The models' device plane (``models/wlan``, ``models/m17``, ``ops/viterbi.py``,
``models/{mcldnn,modrec}.py``):

29. (a) the Viterbi decoder kernel (``csrc/viterbi.cu``: the recursion, packed
    survivors, the traceback) against its plain versions for 802.11's 64
    states, M17's 16 (the butterfly route) and a relabelled 64-state trellis
    (the generic route), at B 1, 8, 256 and buckets 8, 512, 4096, ragged
    frame lengths, on noisy codewords and on all-zero LLRs (every compare a
    tie, every pick 0): survivors equal ``acs_plain``'s picks and decoded
    bits the plain traceback's, bit for bit; its time at B 256 × 4096 (with
    and without the traceback, one frame alone, 16 states, the generic
    route) beside the plain versions, its bound (``utils/roofline``), and its
    sequential floor measured as the step chain alone (``EMPTY_CU``'s
    ``acs_chain_kernel``), with the first design's figures beside it; (b) the
    OFDM head and body demod on the card against the CPU for BPSK, QPSK,
    16-QAM and 64-QAM; the body at a 1,024-symbol bucket, its card time
    (graph replay) and the host time of a ``demod_body_torch`` call; (c) ``perf/wlan.py``'s stream
    (200 QPSK-1/2 frames of 256 bytes, 25 dB) through ``decode_stream_batch``
    on the card: every frame decoded with a good FCS and equal to what was
    sent, frames/s, the decoder's time and the decoded bits' D2H; (d)
    ``apps/wlan_loopback.main()`` on the card, 10 of 10 frames; (e) the pretrained MCLDNN on the card against
    the CPU (TF32 off, the package's setting), its accuracy above 0.9, ``ModClassifier`` in a
    flowgraph, a 256-window forward's time. The kernel's launches are counted
    over (c)'s timed run and (d) and join the ``kernels`` line. The
    decimating ``poly_fir`` at D = 16, m = 8, 2^18 joins phase 7's timings.

The device axis (``models/mcldnn.py`` training, ``parallel/``, ``shard/``,
``tpu/{sp,pp}_block.py``, the engine's slot axis, ``utils/checkpoint.py``), on
a mesh of 4 devices: the cards where there are 4, else 4 logical devices on
card 0 (config ``virtual_devices``; printed as ``mesh: …``), so its D = 4
rates measure the sharding's overhead, not its scaling:

30. (a) ``mcldnn_v1``'s widths (conv 24, LSTM 64, 5 classes, 128 samples)
    trained 30 steps at batch 128: the loss finite and falling, the first
    step's gradients within 1e-3 of a leaf's largest |g| on the CPU, ms a
    step; (b) ``sp_fir_fft_mag2_stream`` (64 taps, FFT 2048) and
    ``sp_fir_stream`` over 3 chained 2^20 frames, ``sp_channelizer`` (PFB-64)
    at 2^18 and ``make_pp_pipeline`` (4 stages), each against its one-device
    chain and its kernels' plain versions, with the mesh's transfer counts
    and rates at D = 1 and 4; (c) ``ShardedProgram`` over the fused spectrum
    chain (2^18, K = 1 and 4) and the FM kernel chain (512,000): every row
    bit-equal to the D = 1 program, no cross-shard transfer, and a
    ``ShardRunner`` dispatch fault recovered bit-equal, rates at D = 1 and
    4; (d) ``ServeEngine(shard_devices=4)`` on the main served chain, 16 ×
    2^18, an evict and readmit included: every session bit-equal to the
    unsharded engine's, both served rates; (e) ``SpKernel`` and ``PpKernel``
    over a (2, 2) mesh in one flowgraph, its state saved midway and restored
    into fresh blocks: resumed equals whole; (f) ``autotune_shard`` over
    widths 1, 2 and 4. The kernels' launches are counted over the sharded
    drives alone (not the comparisons) and join the ``kernels`` line.

The telemetry plane (``telemetry/``: spans, the profile plane, the doctor,
lineage, the journal, the fleet; the control port's routes):

31. (a) the fused spectrum chain (``fir_fft``) streamed at 2^18, K = 1 and
    4, with tracing on: the output bit-equal to tracing off, every dispatch
    group carrying its encode (one a frame), H2D, compute, D2H and decode
    spans, the Chrome trace exported under ``build/`` and parsed, each
    span's median host µs a frame printed; (b) ``fsdr_mfu`` and
    ``fsdr_hbm_util`` in (0, 1.05] for the streamed program and a resident
    ``Pipeline.compile`` (``rotator`` and ``fir``), each capture counted under
    its reason (``warmup``), and a changed carry shape billed as a
    ``reinit`` recapture; (c) serve_ab's chain (``rotator`` and ``fir``
    lanes at 64 × 512): traced bit-equal to untraced, a ``serve_step`` span a
    dispatch, ``E2E_LATENCY`` p50 and p99, ``ServeEngine.step``'s host profile
    by span, its gauges; (d) during a live run held by a gated source, every
    new route of the control port (trace, doctor, profile, lineage, events,
    host, fleet, fleet metrics, a routed admission) answers 200 (201) with
    JSON (the fleet's metrics as text); (e) the doctor's watchdog trips
    ``starved`` on that stall, its flight record names the source, and a
    capture in progress reads ``compiling``; (f) the disabled hooks' cost on
    the streamed K = 1 run by the analytic gate, at most 3%.

32. The mesh across processes: (a) two rank processes (this script with
    ``--rank``) join a ``torch.distributed`` group, gloo where they share the
    one card (each halo between them staged through pinned host memory, the
    stand-in for a network link) and NCCL where each has a card, each owning
    two logical devices of a global mesh of four; ``sp_fir`` (``fir``, 64
    taps) over a 2^21-sample complex64 frame and ``sp_fir_stream`` over 4
    frames, the carry chained, are bit-equal to this process's one-process
    run on four logical devices and within 1e-5 of peak of the ``fir``
    kernel's plain version, with µs a frame at 2 ranks beside one process,
    the cross-rank halos and their bytes, the ``fir`` launches a rank; (b)
    ``mcldnn_v1``'s widths trained data-parallel over the 2 ranks (batch 128,
    10 steps): the same loss on both ranks every step, the first step's
    weights within ``tests/test_torch_train.py``'s ``STEP_TOL`` of the
    one-device step's, ms a step beside it; (c) ``entry()`` on the card
    within 1e-5 of peak of the CPU's logits, and ``dryrun_multichip(4)`` on
    four logical devices on the card; (d) the LoRa loopback app at SF 7 and
    SF 12, every payload decoded, and ``sp_dechirp_scan`` at SF 12 over 16
    modulated frames at 25 dB on four logical devices: the bins the host
    scan's, the concentrations within 1e-5, Msamples/s scanned.

The remaining models (``models/{m17,zigbee,adsb,rattlegram,misc}``, host
numpy as in the reference, and their apps):

33. (a) ``viterbi_decode_m17`` through the port's M17 codec on the card, on
    frames of 512, 1,024 and 4,096 trellis steps at M17's P2 puncturing and
    noise 0.5 on ±1: the bits equal to the float64 numpy trellis and to
    ``ops/viterbi``'s plain version, bit for bit, one ``viterbi`` launch a
    frame (counted over those calls and joining the ``kernels`` line), µs a
    call host to host and the kernel's card time beside its bound; (b) the
    M17 loopback app, its three LSF beacons and a 4-frame stream
    transmission, every one decoded, then ``M17Receiver`` in a flowgraph on a
    stream of 208 frames, every one decoded, frames/s on the host over three
    runs with the flowgraph's start and stop taken out; (c) the ZigBee
    loopback app, every frame with a good FCS, in order; (d) ``adsb_rx`` on its
    synthesized stream, every checkable message with a good CRC24, the
    tracked position within ``tests/test_adsb.py``'s tolerances; (e) the
    Rattlegram loopback app and ``modem_ota`` without and with the callsign
    metadata; (f) the CW beacon's text recovered from its WAV file.

The host plane (``runtime/fastchain.py`` over ``csrc/host/fastchain.cpp``, the
schedulers, the stream, functional, DSP, file and audio blocks, and the apps
that wait for them):

34. (a) the north-star grid of ``perf/fir.py``, 5 pipes of 6 stages of
    ``CopyRand(max_copy 4096) -> Fir(firdes.lowpass(0.2, 64))``, 15,000,000
    float32 samples a pipe, natively fused (3 runs) and on the actor path
    (``FSDR_NO_FASTCHAIN=1``) under ``AsyncScheduler``, ``ThreadedScheduler``
    and ``TpbScheduler`` (one run each, three under ``--hostplane``),
    Msamples/s in total, every sink's count checked as ``perf/fir.py`` does;
    a ``VectorSource``-fed 1 x 6 pipe natively within 1e-5 of peak of the
    actor path; whether the AVX-512 FIR path was built; (b) the grid's
    ``--tpu`` form, each pipe's 6 stages one ``TpuKernel`` of
    ``fir_stage(impl="pallas")`` at frame 2^18 on the f32 wire, under
    ``ThreadedScheduler`` and ``AsyncScheduler``: Msamples/s, the output on
    a seeded input within 1e-5 of peak of the host ``Fir`` cascade (the
    ``fir`` kernel's limit), ``fir`` launched; (c) the apps' ``main()`` as
    subprocesses: ``keyfob_rx`` (loopback, and ``tx --out``), ``ssb_rx
    --wav``, ``file_trx rx``, ``custom_routes`` and ``adsb_rx --file`` on a
    capture ``FileSink`` wrote, each exiting 0 past its own check; (d)
    ``FileSource -> TpuKernel(the fused spectrum chain, fir_fft) -> FileSink``
    on a 2^22-sample complex64 file: the output file bit-equal to the same
    run's from a ``VectorSource``.

``python3 chip_smoke.py --serving`` runs only phase 28 after the build,
``python3 chip_smoke.py --models`` only phase 29, ``python3
chip_smoke.py --sharded`` only phase 30, ``python3 chip_smoke.py
--telemetry`` only phase 31, ``python3 chip_smoke.py --multihost`` only
phase 32, ``python3 chip_smoke.py --protocols`` only phase 33, and ``python3
chip_smoke.py --hostplane`` only phase 34.
``python3 chip_smoke.py --stress N`` runs only phases 4 and 10 once, then the
streamed phases 5 and 11 N times each, each run under a stall watchdog that
prints every thread's stack, the pending asyncio tasks and the block inboxes
and rings before it exits.

Every phase passes or the script exits nonzero. The last line is
``{"ok": true, "device": {...}}``. Needs one CUDA card and the CUDA toolkit
(``nvcc``); run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import faulthandler
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

N_TAPS = 64
N_FFT = 2048
FRAMES = (1 << 18, 1 << 20)
FIR_FFT_EDGE_N = (2, 16, 4096, 8192)   # fir_fft plan edges checked in phase 3
N_CHAIN = 8                  # carry-chained frames per resident check
STREAM_FRAMES = 64           # frames through the streamed flowgraph
STREAM_RUNS = 3              # streamed runs per route (median)
IN_FLIGHT = 4
REPS = 20                    # timed repetitions (median)
SEED = 1234
DEVICE = "cuda:0"            # the one card

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s outside the
# tensor cores (the kernels' FP32 FMA path)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

# Kernel vs plain: max |kernel - plain| <= TOL * max |plain|. Both sum the
# taps in the same order; they differ by the kernel's fused multiply-adds
# (fir, poly_fir), by FFT against DFT-matmul rounding (fir_fft) and by the
# rotator's 2π reduction in double before its sincosf (~2e-7 of peak). quad_demod: max |kernel - plain| <= TOL in
# radians·gain, absolute, after wrapping atan2's ±π branch.
TOL = {"fir": 1e-5, "fir_fft": 1e-4, "rotator": 1e-5, "poly_fir": 1e-5,
       "quad_demod": 1e-5, "pfb": 1e-5}
# Route agreement (fir kernel / fused kernel vs overlap-save via cuFFT) and
# chained-vs-long-frame, relative to the peak of the reference output.
ROUTE_TOL = 1e-4
CHAIN_TOL = 1e-5

# FM front end (futuresdr_tpu_torch/apps/fm_receiver.py at its published width)
FM_RATE = 1e6
FM_OFFSET = 100e3
FM_FRAMES = (512_000, 4_096_000)
FM_CHAIN = 8                 # carry-chained frames per resident check
FM_STREAM_FRAMES = 64        # frames through the streamed flowgraph
FM_WAV_SAMPLES = 1_500_000   # input of the app's WAV run (the default frame)
FM_TRANSIENT = 200           # audio samples skipped before chain comparisons
# Tolerances, in audio units (the test tone's amplitude is 1):
# - kernel chain vs the same chain on plain PyTorch ops: the kernels repeat
#   the plain versions' arithmetic; only summation order and 1-ulp sincos /
#   atan2 differences remain;
# - chained frames vs one long frame at offset 0 (every carry chained, the
#   phase ramps exactly zero);
# - at the 100 kHz offset, chained vs long and app vs kernel chain differ by
#   the float32 phase ramp ph0 + inc·t, whose ulp grows with t: 0.03 rad at
#   t = 5e5 and 0.25 rad at t = 4e6. The reference's folded-vs-unfolded atol
#   5e-3 (tests/test_retune.py:322) holds at the 512,000 frame; the longer
#   frames get FM_PHASE_TOL.
FM_PLAIN_TOL = 1e-4
FM_CHAIN_TOL = 1e-4
FM_APP_TOL = 5e-3
FM_PHASE_TOL = 5e-2
FM_GAIN = 250e3 / (2 * np.pi * 75e3)

# PFB channelizer (channelizer_stage(64) with pfb_default_taps(64): K = 12)
PFB_N = 64
PFB_FRAMES = (1 << 18, 1 << 21)
PFB_CHAIN = 8                # carry-chained frames per resident check
PFB_STREAM_FRAMES = 64       # frames through the streamed flowgraph
PFB_VECTOR_FRAMES = 8        # frames through the deinterleaved flowgraph
PFB_TONE_CHANNELS = (3, 40)
PFB_WIDE_N = 2048            # auto at a width whose rows and taps are not staged
# bf16 kernel vs plain: the plain version rounds its cos/sin matrix to bf16,
# as the JAX kernel does, while the kernel keeps float32 twiddles, so the two
# are held by SNR. The limit lies between the bf16 kernel's reading against
# the plain version and the reading of the kernel in float32 mode (a bf16
# mode that did nothing) on the same inputs; phase 12 checks both sides. On
# an H100 80GB HBM3 the two read 57.6-59.3 dB and 51.4-51.8 dB (PFB-2048 and
# PFB-64).
PFB_BF16_SNR = 54.5
PFB_ROUTE_SNR = 80.0         # pallas vs matmul route (tests/test_precision.py)
PFB_TONE_RATIO = 100.0       # tone channel power over any other (test_dsp_blocks.py)
# deinterleaved flowgraph vs the host block: |got - ref| <= atol·peak + rtol·|ref|
# (tests/test_tpu_stages.py)
PFB_BLOCK_RTOL, PFB_BLOCK_ATOL = 1e-3, 1e-4

# the spectrum app (apps/spectrum.py at its FFT_SIZE 2048, frame 32,768)
SPEC_FRAMES = 64             # app frames streamed
SPEC_TONE = 0.3              # tone frequency, cycles/sample
# app output vs the float64 recomputation: in dB once the EMA has averaged
# 32 spectra (0.9^32 = 3% weight left on the first); before that a noise bin
# can sit near zero power, where float32 FFT rounding is large in dB, so the
# first 32 are held in power relative to each spectrum's peak.
SPEC_SETTLE = 32
SPEC_DB_TOL = 1e-3
SPEC_POWER_TOL = 1e-5

# the host side of the main path (phases 16-17): frames a dispatch compiled
# and streamed, chained dispatches per compiled check; compiled vs eager is
# held at CHAIN_TOL (the same kernels on the same inputs), a retune through
# the compiled carry too, and K = 4 streamed vs K = 1 streamed as well
HOST_K = (1, 4)
# The streamed phases whose checks are bit-equality, or whose tolerance was
# set for a float32 link (5, 11, 14-18, 21-24), pin the f32 wire, so they
# keep measuring what they measured before the wire codecs; on a card the
# default wire is sc16 (ops/wire.py resolve_wire), which the apps' phases
# 19-20 keep and phase 25 holds against f32.
LINK = "f32"
HOST_DISPATCHES = 3
# device sleep before a timed run of calls (~60 ms): the host enqueues them
# all before the card reaches the first, so the card's time is what is timed
HOST_SLEEP_CYCLES = 100_000_000

REPLACES = {"fir": "futuresdr_tpu/ops/pallas_kernels.py:115",
            "fir_fft": "futuresdr_tpu/ops/pallas_kernels.py:408",
            "rotator": "futuresdr_tpu/ops/pallas_kernels.py:535",
            "poly_fir": "futuresdr_tpu/ops/pallas_kernels.py:326",
            "quad_demod": "futuresdr_tpu/ops/pallas_kernels.py:597",
            "pfb": "futuresdr_tpu/ops/pallas_kernels.py:225"}
SOURCES = {k: f"futuresdr_tpu_torch/csrc/{k}.cu" for k in REPLACES}
# Each timed call's time in PERF.md's kernel table before the kernel's latest
# redesign (NVIDIA H100 80GB HBM3, 700.00 W), in ms, printed beside the time
# measured now.
EARLIER_MS = {
    ("fir", 1 << 18): 0.0087, ("fir", 1 << 20): 0.0241,
    ("fir_fft", 1 << 18): 0.0174, ("fir_fft", 1 << 20): 0.0517,
    ("rotator", 512_000): 0.0058, ("rotator", 4_096_000): 0.0254,
    ("poly_fir", 512_000): 0.0218, ("poly_fir", 4_096_000): 0.1066,
    ("poly_fir/channel", 512_000): 0.0139, ("poly_fir/resampler", 512_000): 0.0080,
    ("poly_fir/resampler", 4_096_000): 0.0298,
    ("quad_demod", 512_000): 0.0020, ("quad_demod", 4_096_000): 0.0068,
    ("pfb", 1 << 18): 0.0103, ("pfb", 1 << 21): 0.0391, ("pfb/N=2048", 1 << 18): 0.0474,
}
SPECTRUM_KERNELS = ("fir", "fir_fft")
FM_KERNELS = ("rotator", "poly_fir", "quad_demod")
PFB_KERNELS = ("pfb",)


# Yardsticks built here beside the port's kernels; no library of the port
# holds them. A kernel with no body, launched on a given grid: the cost of a
# launch alone, for the FM kernels' timings. And the Viterbi kernel's step
# chain alone: csrc/viterbi.cu's butterfly step for one 64-state frame, one
# warp, with the same two shuffles, products, sums, maxima, pick compares,
# ballots and keeps a step but no load or store inside the loop (each step's
# LLRs are made in registers, only the last metrics and ballots are written):
# the sequential floor of that design's recursion, measured.
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int fsdr_empty(unsigned blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

__device__ __forceinline__ float cand(float m, float w0, float l0, float w1, float l1) {
  return __fadd_rn(__fadd_rn(m, __fmul_rn(w0, l0)), __fmul_rn(w1, l1));
}

__global__ void __launch_bounds__(32)
acs_chain_kernel(const float2* __restrict__ bm0, const float2* __restrict__ bm1,
                 float* __restrict__ out, long long n_steps) {
  const unsigned full = 0xffffffffu;
  const int j = threadIdx.x & 31;
  const bool upper = j >= 16, odd = j & 1;
  const int src1 = upper ? 2 * j - 31 : 2 * j;
  const int src2 = upper ? 2 * j - 32 : 2 * j + 1;
  const int n[2] = {odd ? j + 32 : j, odd ? j : j + 32};
  float a0[2], a1[2], b0[2], b1[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const float2 u = bm0[n[o]], v = bm1[n[o]];
    a0[o] = upper ? u.y : u.x;
    a1[o] = upper ? v.y : v.x;
    b0[o] = upper ? u.x : u.y;
    b1[o] = upper ? v.x : v.y;
  }
  float x = j == 0 ? 0.0f : -1e18f, y = -1e18f;
  unsigned keep = 0;
  const int base0 = __float_as_int(0.75f), base1 = __float_as_int(-1.25f);
  for (long long t0 = 0; t0 < n_steps; t0 += 32) {
    unsigned r_lo = 0, r_hi = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float l0 = __int_as_float(base0 ^ ((static_cast<int>(t0) + i) << 8));
      const float l1 = __int_as_float(base1 ^ (i << 9));
      const float ra = __shfl_sync(full, x, src1);
      const float rb = __shfl_sync(full, y, src2);
      float ca[2], cb[2];
      bool p[2];
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        ca[o] = cand(ra, a0[o], l0, a1[o], l1);
        cb[o] = cand(rb, b0[o], l0, b1[o], l1);
        p[o] = upper ? ca[o] > cb[o] : cb[o] > ca[o];
      }
      x = fmaxf(ca[0], cb[0]);
      y = fmaxf(ca[1], cb[1]);
      const unsigned lo = __ballot_sync(full, odd ? p[1] : p[0]);
      const unsigned hi = __ballot_sync(full, odd ? p[0] : p[1]);
      if (j == i) {
        r_lo = lo;
        r_hi = hi;
      }
    }
    keep ^= r_lo ^ (r_hi << 1);
  }
  out[j] = x;
  out[j + 32] = y;
  out[j + 64] = __uint_as_float(keep);
}
extern "C" int fsdr_acs_chain(const void* bm0, const void* bm1, void* out, long long n_steps,
                              void* stream) {
  acs_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(bm0), static_cast<const float2*>(bm1),
      static_cast<float*>(out), n_steps);
  return cudaGetLastError();
}
"""


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def rel_err(got, ref) -> tuple:
    """``(max |got - ref|, that over max |ref|)`` in float64 on the host."""
    g = got.detach().cpu().numpy().astype(np.complex128)
    r = ref.detach().cpu().numpy().astype(np.complex128)
    err = float(np.max(np.abs(g - r))) if r.size else 0.0
    peak = float(np.max(np.abs(r))) if r.size else 0.0
    return err, err / max(peak, 1e-30)


def snr_db(got, ref) -> float:
    """``10·log10(mean |ref|² / mean |got - ref|²)`` in float64 on the host."""
    g = got.detach().cpu().numpy().astype(np.complex128)
    r = ref.detach().cpu().numpy().astype(np.complex128)
    err = float(np.mean(np.abs(g - r) ** 2))
    return float(10 * np.log10(np.mean(np.abs(r) ** 2) / max(err, 1e-300)))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int = 0) -> float:
    """Median time between CUDA events around ``fn()`` over ``reps`` runs:
    device time plus any wait for the host, the rate an eager caller gets."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps or REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, args_list, reps: int = 0) -> float:
    """Median device time of one ``fn(*args)`` call, without host overhead:
    the calls over every ``args`` in ``args_list`` are captured in one CUDA
    graph, and each timed replay runs behind a device sleep, so the host
    enqueues it before the device reaches it. Distinct inputs per call keep
    them out of L2 when ``args_list`` holds more than 50 MB."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up: library plans and handles
        for a in args_list[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*a) for a in args_list]
    times = []
    for _ in range(reps or REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(args_list))
    del graph, outs
    return statistics.median(times)


def randc(n: int, gen, dev):
    import torch
    return torch.randn(n, dtype=torch.complex64, generator=gen, device=dev)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(dev):
    """(kernel, label, kernel call, plain call) at the path's shapes and at
    ragged ones."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames, n_fft, nt = FRAMES, N_FFT, N_TAPS

    def real(n):
        return torch.randn(n, dtype=torch.float32, generator=gen, device=dev)

    cases = []
    for n in frames:
        x, hist, taps = randc(n, gen, dev), randc(nt - 1, gen, dev), real(nt)
        for prec in (None, "bf16"):
            cases.append(("fir", f"fir_continue c64 n={n} nt={nt} {prec or 'f32'}",
                          lambda x=x, h=hist, t=taps, p=prec: ck.fir_continue(h, x, t, p),
                          lambda x=x, h=hist, t=taps, p=prec: ck.fir_continue_plain(h, x, t, p)))
            cases.append(("fir_fft", f"fir_fft c64 n={n} nt={nt} n_fft={n_fft} {prec or 'f32'}",
                          lambda x=x, h=hist, t=taps, p=prec: ck.fir_fft(h, x, t, n_fft, p),
                          lambda x=x, h=hist, t=taps, p=prec: ck.fir_fft_plain(h, x, t, n_fft, p)))
        cases.append(("fir", f"fir c64 n={n} nt={nt} zero state",
                      lambda x=x, t=taps: ck.fir(x, t),
                      lambda x=x, t=taps: ck.fir_plain(x, t)))
    # ragged: a frame that is not a multiple of the tile, a real stream,
    # short taps, small and non-power-of-two transforms, ragged row counts
    xr, t17 = real(frames[0] + 1000), real(17)
    for prec in (None, "bf16"):
        cases.append(("fir", f"fir f32 n={frames[0] + 1000} nt=17 {prec or 'f32'}",
                      lambda p=prec: ck.fir(xr, t17, p),
                      lambda p=prec: ck.fir_plain(xr, t17, p)))
    # a tap set too long for padded spans: the plan takes one unpadded warp a block
    xl, hl, tl = randc(20_000, gen, dev), randc(17_999, gen, dev), real(18_000)
    cases.append(("fir", "fir_continue c64 n=20000 nt=18000 f32 (one unpadded warp)",
                  lambda: ck.fir_continue(hl, xl, tl),
                  lambda: ck.fir_continue_plain(hl, xl, tl)))
    for nf, ntt, rows, cplx in ((128, 17, 7, True), (1000, 33, 5, True),
                                (2047, 64, 3, True), (256, 64, 9, False)):
        x = randc(nf * rows, gen, dev) if cplx else real(nf * rows)
        hist = randc(ntt - 1, gen, dev) if cplx else real(ntt - 1)
        t = real(ntt)
        for prec in (None, "bf16"):
            cases.append(("fir_fft",
                          f"fir_fft {'c64' if cplx else 'f32'} n_fft={nf} nt={ntt} "
                          f"rows={rows} {prec or 'f32'}",
                          lambda x=x, h=hist, t=t, nf=nf, p=prec: ck.fir_fft(h, x, t, nf, p),
                          lambda x=x, h=hist, t=t, nf=nf, p=prec:
                          ck.fir_fft_plain(h, x, t, nf, p)))
    # the plan's edges: one-pass and two-pass transforms, the largest rows
    # (8192 with 8192 taps falls back to the unpadded layout with the
    # twiddles read from device memory), the shortest and longest tap sets
    for nf in FIR_FFT_EDGE_N:
        for ntt in (2, nf):
            x, hist, t = randc(nf, gen, dev), randc(ntt - 1, gen, dev), real(ntt)
            for prec in (None, "bf16"):
                cases.append(("fir_fft", f"fir_fft c64 n_fft={nf} nt={ntt} rows=1 "
                                         f"{prec or 'f32'}",
                              lambda x=x, h=hist, t=t, nf=nf, p=prec: ck.fir_fft(h, x, t, nf, p),
                              lambda x=x, h=hist, t=t, nf=nf, p=prec:
                              ck.fir_fft_plain(h, x, t, nf, p)))
    return cases


def demod_err(got, ref) -> float:
    """max |got - ref| after wrapping the difference into (−π·gain, π·gain]:
    at Im z ≈ ±0 with Re z < 0, atan2 flips between +π and −π on a last-bit
    difference of its arguments."""
    period = 2 * np.pi * FM_GAIN
    d = got.detach().cpu().double() - ref.detach().cpu().double()
    d = d - period * (d / period).round()
    return float(d.abs().max()) if d.numel() else 0.0


def phase_kernels(dev, cases) -> dict:
    """Every case within its tolerance; returns the worst error per kernel."""
    import torch
    worst = {}
    for name, label, kern, plain in cases:
        got = kern()
        ref = plain()
        if name == "quad_demod":
            (got, last), (ref, ref_last) = got, ref
            check(last.item() == ref_last.item(), f"{label}: carry sample differs")
        if name == "rotator":
            (got, ph_next), (ref, ref_next) = got, ref
            check(ph_next.shape == ref_next.shape and ph_next.item() == ref_next.item(),
                  f"{label}: next phase {ph_next.item()!r}, torch.remainder gives "
                  f"{ref_next.item()!r}")
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{label}: kernel gives {tuple(got.shape)} {got.dtype}, plain "
              f"{tuple(ref.shape)} {ref.dtype}")
        check(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                  else got).all()), f"{label}: non-finite output")
        if name == "quad_demod":
            err = rel = demod_err(got, ref)
            print(f"kernel {label}: max_abs_err {err:.3e} (wrapped, tol {TOL[name]:g})")
        elif name == "pfb" and label.endswith("bf16"):
            err, _ = rel_err(got, ref)
            snr = snr_db(got, ref)
            off = snr_db(kern.f32_mode(), ref)
            print(f"kernel {label}: max_abs_err {err:.3e}, {snr:.2f} dB against the "
                  f"plain version (min {PFB_BF16_SNR:g} dB); the kernel in f32 mode "
                  f"{off:.2f} dB (must fall below)")
            check(snr >= PFB_BF16_SNR, f"{label}: {snr:.2f} dB under {PFB_BF16_SNR:g}")
            check(off < PFB_BF16_SNR, f"{label}: the f32-mode kernel reads {off:.2f} dB, "
                                      f"the limit {PFB_BF16_SNR:g} cannot tell bf16 apart")
            worst[name] = max(worst.get(name, 0.0), err)
            continue
        else:
            err, rel = rel_err(got, ref)
            print(f"kernel {label}: max_abs_err {err:.3e} ({rel:.3e} of peak, "
                  f"tol {TOL[name]:g})")
        check(rel <= TOL[name], f"{label}: error {rel:.3e} over {TOL[name]:g}")
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------

def chain_stages(route: str, taps):
    from futuresdr_tpu_torch.ops.stages import (fft_stage, fir_fft_stage, fir_stage,
                                                mag2_stage)
    if route == "fused":
        return [fir_fft_stage(taps, N_FFT), mag2_stage()]
    return [fir_stage(taps, impl=route), fft_stage(N_FFT), mag2_stage()]


ROUTES = ("os", "pallas", "fused")
ROUTE_KERNEL = {"os": None, "pallas": "fir", "fused": "fir_fft"}


def run_resident(route, taps, frames, dev):
    """The chain over ``frames`` (a list of device tensors), carry chained."""
    import torch

    from futuresdr_tpu_torch.ops.stages import Pipeline
    pipe = Pipeline(chain_stages(route, taps), np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for x in frames:
        carry, y = fn(carry, x)
        outs.append(y)
    return torch.cat(outs)


def phase_resident(dev, taps) -> dict:
    """Routes agree, chained equals one long frame; returns Msps per
    (route, frame)."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops.stages import Pipeline
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rates, n_chain = {}, N_CHAIN
    for f in FRAMES:
        xs = [randc(f, gen, dev) for _ in range(n_chain)]
        ref = None
        for route in ROUTES:
            before = dict(ck.launches)
            chained = run_resident(route, taps, xs, dev)
            long_ = run_resident(route, taps, [torch.cat(xs)], dev)
            k = ROUTE_KERNEL[route]
            if k is not None:
                check(ck.launches[k] > before[k],
                      f"resident {route} frame={f}: kernel {k} was not launched")
            check(chained.shape == (n_chain * f,) and chained.dtype == torch.float32,
                  f"resident {route}: output {tuple(chained.shape)} {chained.dtype}")
            check(bool(torch.isfinite(chained).all()), f"resident {route}: non-finite")
            _, rel = rel_err(chained, long_)
            print(f"resident {route} frame={f}: {n_chain} chained vs one long frame "
                  f"{rel:.3e} of peak (tol {CHAIN_TOL:g})")
            check(rel <= CHAIN_TOL, f"resident {route} frame={f}: chained frames "
                                    f"differ from one long frame by {rel:.3e}")
            if ref is None:
                ref = chained
            else:
                _, rel = rel_err(chained, ref)
                print(f"resident {route} frame={f}: vs overlap-save {rel:.3e} of peak "
                      f"(tol {ROUTE_TOL:g})")
                check(rel <= ROUTE_TOL, f"resident {route} frame={f}: differs from "
                                        f"overlap-save by {rel:.3e}")
            pipe = Pipeline(chain_stages(route, taps), np.complex64)
            fn, state = pipe.fn(), [pipe.init_carry(dev)]

            def step(fn=fn, state=state, xs=xs):
                c = state[0]
                for x in xs:
                    c, _ = fn(c, x)
                state[0] = c

            ms = cuda_ms(step)
            rates[(route, f)] = n_chain * f / (ms * 1e-3) / 1e6
    return rates


def _stream_kernel(route, taps, frame, dev):
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    return TpuKernel(chain_stages(route, taps), np.complex64, frame_size=frame,
                     inst=TpuInstance(dev), frames_in_flight=IN_FLIGHT, wire=LINK)


def phase_streamed(dev, taps) -> dict:
    """NullSource -> Head -> TpuKernel -> NullSink per route (item count and
    rate), and VectorSource -> TpuKernel -> VectorSink against the resident
    chain; returns streamed Msps per route."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, VectorSink,
                                            VectorSource)
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    rates, frame = {}, FRAMES[0]
    n_items = STREAM_FRAMES * frame
    for route in ROUTES:
        runs = []
        for _ in range(STREAM_RUNS):
            before = dict(ck.launches)
            fg = Flowgraph()
            snk = NullSink(np.float32)
            fg.connect(NullSource(np.complex64), Head(np.complex64, n_items),
                       _stream_kernel(route, taps, frame, dev), snk)
            rt = Runtime()
            t0 = time.perf_counter()
            rt.run(fg)
            runs.append(time.perf_counter() - t0)
            rt.shutdown()
            check(snk.n_received == n_items,
                  f"streamed {route}: NullSink got {snk.n_received} items, want {n_items}")
            k = ROUTE_KERNEL[route]
            if k is not None:
                check(ck.launches[k] > before[k], f"streamed {route}: kernel {k} not launched")
        rates[route] = n_items / statistics.median(runs) / 1e6
        print(f"streamed {route}: {n_items} items through NullSource -> Head -> "
              f"TpuKernel -> NullSink in {', '.join(f'{t:.3f}' for t in runs)} s")

    # VectorSource -> TpuKernel -> VectorSink, with a partial last frame,
    # against the resident chain over the same zero-padded frames
    rng = np.random.default_rng(SEED + 2)
    tail = 3 * N_FFT + 100
    host = (rng.standard_normal(8 * frame + tail)
            + 1j * rng.standard_normal(8 * frame + tail)).astype(np.complex64)
    for route in ROUTES:
        kern = _stream_kernel(route, taps, frame, dev)
        fm = kern.pipeline.frame_multiple
        fg = Flowgraph()
        vsnk = VectorSink(np.float32)
        fg.connect(VectorSource(host), kern, vsnk)
        rt = Runtime()
        rt.run(fg)
        rt.shutdown()
        got = vsnk.items()
        want_n = 8 * frame + tail - tail % fm
        check(len(got) == want_n, f"vector {route}: {len(got)} items, want {want_n}")
        padded = np.zeros(9 * frame, np.complex64)
        padded[:len(host)] = host
        xs = [torch.from_numpy(padded[i * frame:(i + 1) * frame]).to(dev) for i in range(9)]
        ref = run_resident(route, taps, xs, dev)[:want_n]
        _, rel = rel_err(torch.from_numpy(got), ref)
        print(f"vector {route}: {len(got)} items, vs resident chain {rel:.3e} of peak")
        check(rel <= CHAIN_TOL, f"vector {route}: differs from the resident chain by {rel:.3e}")
    return rates


def phase_retune(dev, taps, taps2) -> None:
    """Swap the taps while frames stream; the output must equal the resident
    chain with the swap at the frame the kernel reports."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops.stages import Pipeline
    frame, n_frames = FRAMES[0], STREAM_FRAMES
    rng = np.random.default_rng(SEED + 3)
    host = (rng.standard_normal(n_frames * frame)
            + 1j * rng.standard_normal(n_frames * frame)).astype(np.complex64)
    for route in ("pallas", "fused"):
        kern = _stream_kernel(route, taps, frame, dev)
        fg = Flowgraph()
        vsnk = VectorSink(np.float32)
        fg.connect(VectorSource(host), kern, vsnk)
        rt = Runtime()
        running = rt.start(fg)
        deadline = time.monotonic() + 60
        while kern.frames_dispatched < 4:
            check(time.monotonic() < deadline, f"retune {route}: stream did not start")
            time.sleep(0.0005)
        at = kern.apply_retune(0, taps=taps2)
        running.wait_sync()
        rt.shutdown()
        check(0 < at < n_frames, f"retune {route}: landed at frame {at} of {n_frames}, "
                                 f"not mid-stream")
        pipe = Pipeline(chain_stages(route, taps), np.complex64)
        fn, carry = pipe.fn(), pipe.init_carry(dev)
        outs = []
        for i in range(n_frames):
            if i == at:
                carry = pipe.update_stage(carry, 0, taps=taps2)
            carry, y = fn(carry, torch.from_numpy(host[i * frame:(i + 1) * frame]).to(dev))
            outs.append(y)
        _, rel = rel_err(torch.from_numpy(vsnk.items()), torch.cat(outs))
        print(f"retune {route}: taps swapped at frame {at} of {n_frames}; vs resident "
              f"chain with the same swap {rel:.3e} of peak")
        check(rel <= CHAIN_TOL, f"retune {route}: differs by {rel:.3e}")


# ---------------------------------------------------------------------------
# phase 7: kernel timings beside their bounds
# ---------------------------------------------------------------------------

def kernel_timings(dev, n: int, taps_np) -> dict:
    """Kernel, plain and library device time and the bound of each kernel on
    the main path's call at frame ``n`` (complex64, 64 taps, N = 2048)."""
    import torch
    import torch.nn.functional as F

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    nt, n_fft = N_TAPS, N_FFT
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    taps = torch.from_numpy(taps_np).to(dev)
    # REPS distinct frames per graph: 20 x 16 B x 2^18 = 84 MB > L2
    args = [(randc(nt - 1, gen, dev), randc(n, gen, dev)) for _ in range(REPS)]
    w = taps.flip(0).view(1, 1, nt).contiguous()   # conv1d correlates
    # library yardsticks, timed only here and never called by the port:
    # conv1d over the two float planes, then torch.fft for fir_fft
    planes = [(torch.view_as_real(torch.cat([h, x])).t().contiguous().unsqueeze(1),)
              for h, x in args]

    def lib_fir(p):
        return F.conv1d(p, w)

    def lib_fir_fft(p):
        y = F.conv1d(p, w)
        return torch.fft.fft(torch.complex(y[0, 0], y[1, 0]).view(-1, n_fft), dim=1)

    io_bytes = (n + nt - 1) * 8 + nt * 4 + n * 8
    work = {
        "fir": (lambda h, x: ck.fir_continue(h, x, taps),
                lambda h, x: ck.fir_continue_plain(h, x, taps), lib_fir,
                io_bytes, 4 * nt * n),
        "fir_fft": (lambda h, x: ck.fir_fft(h, x, taps, n_fft),
                    lambda h, x: ck.fir_fft_plain(h, x, taps, n_fft), lib_fir_fft,
                    io_bytes + n_fft * 8,
                    n * (4 * nt + 5 * int(np.log2(n_fft)))),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, flops) in work.items():
        err, _ = rel_err(kern(*args[0]), plain(*args[0]))
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
        out[name] = {
            "ms": device_ms(kern, args), "plain_ms": device_ms(plain, args),
            "library_ms": device_ms(lib, planes),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err,
        }
    return out


# ---------------------------------------------------------------------------
# phases 9-11: the FM front end
# ---------------------------------------------------------------------------

FM_THETA = -2 * np.pi * FM_OFFSET / FM_RATE


def fm_kernel_cases(dev):
    """(kernel, label, kernel call, plain call) for the three FM kernels at
    the FM chain's shapes (frame F in, F/4 after the channel filter), at
    ragged ones, at large phases and in bf16."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def real(*shape):
        return torch.randn(*shape, dtype=torch.float32, generator=gen, device=dev)

    cases = []
    ph0 = torch.tensor(1.25, dtype=torch.float32, device=dev)
    inc = torch.tensor(FM_THETA, dtype=torch.float32, device=dev)
    # the FM frames, a ragged one, the views x[1:] (a head sample before the
    # first 16-byte word) and x[:-1], and the blocks' edges: 1-3 samples and
    # one tile +- 1 after a head
    rot_tile = ck.ROTATOR_TILE
    rot_x = [(f"n={n}", randc(n, gen, dev)) for n in FM_FRAMES + (FM_FRAMES[0] + 333,)]
    rot_x += [(f"n={n} x[1:]", randc(n + 1, gen, dev)[1:]) for n in FM_FRAMES]
    rot_x += [(f"n={n} x[:-1]", randc(n + 1, gen, dev)[:-1]) for n in (FM_FRAMES[0],)]
    rot_x += [(f"n={n} x[1:]", randc(n + 1, gen, dev)[1:])
              for n in (1, 2, 3, rot_tile, rot_tile + 1, rot_tile + 2)]
    rot_x += [(f"n={n}", randc(n, gen, dev)) for n in (1, 2, 3, rot_tile - 1, rot_tile + 1)]
    for label, x in rot_x:              # |ph| reaches 0.63·n rad
        n = x.shape[0]
        cases.append(("rotator", f"rotator c64 {label} |ph|<={abs(FM_THETA) * n:.3g}",
                      lambda x=x: ck.rotator(x, ph0, inc),
                      lambda x=x: ck.rotator_plain(x, ph0, inc)))
    # the carry beside +-pi, where the remainder's sign flips
    for p0 in (np.float32(np.pi) - 1e-6, np.float32(-np.pi) + 1e-6):
        p0t = torch.tensor(p0, dtype=torch.float32, device=dev)
        for label, x in [rot_x[0], next(c for c in rot_x if c[0] == "n=1")]:
            cases.append(("rotator", f"rotator c64 {label} ph0={p0:.7f}",
                          lambda x=x, p=p0t: ck.rotator(x, p, inc),
                          lambda x=x, p=p0t: ck.rotator_plain(x, p, inc)))
    prev = randc(1, gen, dev).reshape(())
    n4 = FM_FRAMES[0] // 4
    dem_tile = ck.QUAD_DEMOD_TILE
    dem_x = [(f"n={n}", randc(n, gen, dev))
             for n in (n4, FM_FRAMES[1] // 4, n4 + 77, 1, 2, 3, dem_tile - 1, dem_tile + 1)]
    dem_x += [(f"n={n} x[1:]", randc(n + 1, gen, dev)[1:])
              for n in (n4, FM_FRAMES[1] // 4, 1, 2, 3, dem_tile, dem_tile + 1, dem_tile + 2)]
    dem_x += [(f"n={n4} x[:-1]", randc(n4 + 1, gen, dev)[:-1])]
    for label, x in dem_x:
        cases.append(("quad_demod", f"quad_demod c64 {label}",
                      lambda x=x: ck.quad_demod(prev, x, FM_GAIN),
                      lambda x=x: ck.quad_demod_plain(prev, x, FM_GAIN)))
    # channel filter: D = 4, m = 32, complex; resampler: D = 125, I = 24, m = 2
    w2, w3 = real(33, 4), real(3, 125, 24)
    shapes = [("2-D D=4 m=32 c64", w2, FM_FRAMES[0] // 4, True),
              ("2-D D=4 m=32 c64", w2, FM_FRAMES[1] // 4, True),
              ("2-D D=4 m=32 c64 ragged", w2, FM_FRAMES[0] // 4 - 223, True),
              ("3-D D=125 I=24 m=2 f32", w3, FM_FRAMES[0] // 500, False),
              ("3-D D=125 I=24 m=2 f32", w3, FM_FRAMES[1] // 500, False),
              ("3-D D=125 I=24 m=2 c64 ragged", w3, 1021, True)]
    # the plans' tile edges: nq = 1 and one tile +- 1 of each tiling, D = 1,
    # an odd D, m = 1 (the gemm tiling at I = 1), I = 24 on a complex stream
    rows_tile = ck.poly_fir_plan(32, 4, 1, 1, True).rows
    gemm_tile = ck.poly_fir_plan(2, 125, 24, 1, True).rows
    shapes += [("2-D D=4 m=32 c64 edge", w2, nq, True)
               for nq in (1, rows_tile - 1, rows_tile + 1)]
    shapes += [("3-D D=125 I=24 m=2 c64 edge", w3, nq, True)
               for nq in (1, gemm_tile - 1, gemm_tile + 1, FM_FRAMES[1] // 500)]
    shapes += [("2-D D=1 m=63 f32", real(64, 1), 1001, False),
               ("2-D D=5 m=8 c64", real(9, 5), 777, True),
               ("2-D D=8 m=1 f32", real(2, 8), 1000, False)]
    for label, w, nq, cplx in shapes:
        m, D = w.shape[0] - 1, w.shape[1]
        hist = randc(m * D, gen, dev) if cplx else real(m * D)
        x = randc(nq * D, gen, dev) if cplx else real(nq * D)
        for prec in (None, "bf16"):
            ww = w.to(torch.bfloat16) if prec else w     # the stage carries bf16 W
            cases.append(("poly_fir", f"poly_fir {label} nq={nq} {prec or 'f32'}",
                          lambda h=hist, x=x, w=ww, p=prec: ck.poly_fir(h, x, w, p),
                          lambda h=hist, x=x, w=ww, p=prec: ck.poly_fir_plain(h, x, w, p)))
    return cases


def fm_iq(n: int, dev, offset: float = FM_OFFSET):
    """A 1 kHz tone, FM-modulated at 75 kHz deviation, at ``offset`` from the
    tuned frequency: complex64 on ``dev``, built in float64 on the device."""
    import torch
    t = torch.arange(n, dtype=torch.float64, device=dev) / FM_RATE
    msg = torch.sin(2 * np.pi * 1000.0 * t)
    ph = 2 * np.pi * 75e3 * torch.cumsum(msg, 0) / FM_RATE + 2 * np.pi * offset * t
    return torch.polar(torch.ones_like(ph), ph).to(torch.complex64)


def fm_stages(chain: str, offset: float = FM_OFFSET):
    """``app``: the shipped front end; ``kernel``: the unfolded chain pinned
    to the hand kernels; ``plain``: the same chain on plain PyTorch ops."""
    from futuresdr_tpu_torch.apps.fm_receiver import front_end_stages
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import (fir_stage, quad_demod_stage,
                                                resample_stage, rotator_stage)
    if chain == "app":
        return front_end_stages(FM_RATE, offset)
    k = chain == "kernel"
    return [rotator_stage(-2 * np.pi * offset / FM_RATE, name="tuner",
                          impl="pallas" if k else "xla"),
            fir_stage(firdes.lowpass(0.5 / 4 * 0.8, 128), decim=4,
                      impl="pallas" if k else "poly", name="chan"),
            quad_demod_stage(FM_GAIN, impl="pallas" if k else "xla"),
            resample_stage(24, 125, impl="pallas" if k else "poly")]


FM_CHAINS = ("app", "kernel", "plain")


def run_fm(chain, frames, dev, offset: float = FM_OFFSET):
    import torch

    from futuresdr_tpu_torch.ops.stages import Pipeline
    pipe = Pipeline(fm_stages(chain, offset), np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for x in frames:
        carry, y = fn(carry, x)
        outs.append(y)
    return torch.cat(outs)


def max_abs(a, b, skip: int = 0) -> float:
    return float((a[skip:].double() - b[skip:].double()).abs().max())


def phase_fm_resident(dev) -> dict:
    """Both chains at each FM frame, 8 frames chained; returns Msps per
    (chain, frame)."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops.stages import Pipeline
    rates = {}
    for f in FM_FRAMES:
        x = fm_iq(FM_CHAIN * f, dev)
        xs = list(x.split(f))
        before = dict(ck.launches)
        out = {c: run_fm(c, xs, dev) for c in FM_CHAINS}
        for k in FM_KERNELS:
            check(ck.launches[k] > before[k], f"fm resident frame={f}: {k} not launched")
        n_out = FM_CHAIN * f * 24 // 500
        for c, y in out.items():
            check(y.shape == (n_out,) and y.dtype == torch.float32,
                  f"fm resident {c}: output {tuple(y.shape)} {y.dtype}")
            check(bool(torch.isfinite(y).all()), f"fm resident {c}: non-finite")
        err = max_abs(out["kernel"], out["plain"])
        print(f"fm resident frame={f}: kernel chain vs plain-op chain {err:.3e} "
              f"(tol {FM_PLAIN_TOL:g})")
        check(err <= FM_PLAIN_TOL, f"fm frame={f}: kernel chain differs from the "
                                   f"plain-op chain by {err:.3e}")
        err = max_abs(out["app"], out["kernel"], FM_TRANSIENT)
        tol = FM_APP_TOL if f == FM_FRAMES[0] else FM_PHASE_TOL
        print(f"fm resident frame={f}: app chain vs kernel chain {err:.3e} after "
              f"{FM_TRANSIENT} samples (tol {tol:g})")
        check(err <= tol, f"fm frame={f}: app chain differs from the kernel chain "
                          f"by {err:.3e}")
        # chained vs one long frame: at offset 0 every carry is chained and
        # the phase ramps are exactly zero; at the real offset the long
        # frame's float32 ramp is coarser (FM_PHASE_TOL)
        x0 = fm_iq(FM_CHAIN * f, dev, offset=0.0)
        for c in ("app", "kernel"):
            err = max_abs(run_fm(c, list(x0.split(f)), dev, 0.0),
                          run_fm(c, [x0], dev, 0.0))
            print(f"fm resident {c} frame={f} offset 0: {FM_CHAIN} chained vs one "
                  f"long frame {err:.3e} (tol {FM_CHAIN_TOL:g})")
            check(err <= FM_CHAIN_TOL, f"fm {c} frame={f}: chained frames differ "
                                       f"from one long frame by {err:.3e}")
            if f == FM_FRAMES[0]:
                err = max_abs(out[c], run_fm(c, [x], dev))
                print(f"fm resident {c} frame={f} offset {FM_OFFSET:g}: chained vs "
                      f"one long frame {err:.3e} (tol {FM_PHASE_TOL:g})")
                check(err <= FM_PHASE_TOL, f"fm {c} frame={f}: chained frames differ "
                                           f"from one long frame by {err:.3e}")
        del x0
        for c in FM_CHAINS:
            pipe = Pipeline(fm_stages(c), np.complex64)
            fn, state = pipe.fn(), [pipe.init_carry(dev)]

            def step(fn=fn, state=state, xs=xs):
                cc = state[0]
                for xx in xs:
                    cc, _ = fn(cc, xx)
                state[0] = cc

            ms = cuda_ms(step)
            rates[(c, f)] = FM_CHAIN * f / (ms * 1e-3) / 1e6
        del x, xs, out
    return rates


def _fm_kernel_block(chain, frame, dev, depth=IN_FLIGHT):
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    return TpuKernel(fm_stages(chain), np.complex64, frame_size=frame,
                     inst=TpuInstance(dev), frames_in_flight=depth, wire=LINK)


def phase_fm_streamed(dev) -> dict:
    """NullSource -> Head(64 frames) -> TpuKernel -> NullSink per chain;
    returns streamed Msps per chain."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    rates, frame = {}, FM_FRAMES[0]
    n_items = FM_STREAM_FRAMES * frame
    for chain in ("app", "kernel"):
        runs = []
        for _ in range(STREAM_RUNS):
            before = dict(ck.launches)
            fg = Flowgraph()
            snk = NullSink(np.float32)
            fg.connect(NullSource(np.complex64), Head(np.complex64, n_items),
                       _fm_kernel_block(chain, frame, dev), snk)
            rt = Runtime()
            t0 = time.perf_counter()
            rt.run(fg)
            runs.append(time.perf_counter() - t0)
            rt.shutdown()
            want = n_items * 24 // 500
            check(snk.n_received == want,
                  f"fm streamed {chain}: NullSink got {snk.n_received} items, want {want}")
            if chain == "kernel":
                for k in FM_KERNELS:
                    check(ck.launches[k] > before[k], f"fm streamed: {k} not launched")
        rates[chain] = n_items / statistics.median(runs) / 1e6
        print(f"fm streamed {chain}: {n_items} items through NullSource -> Head -> "
              f"TpuKernel -> NullSink in {', '.join(f'{t:.3f}' for t in runs)} s")
    return rates


def phase_fm_retune(dev) -> None:
    """apply_retune("tuner", phase_inc=…) while frames stream, on both chains:
    the audio equals the resident chain with the retune at the frame the
    kernel reports."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops.stages import Pipeline
    frame, n_frames = FM_FRAMES[0], 16
    host = fm_iq(n_frames * frame, dev).cpu().numpy()
    theta2 = -2 * np.pi * 150e3 / FM_RATE
    for chain in ("app", "kernel"):
        kern = _fm_kernel_block(chain, frame, dev)
        fg = Flowgraph()
        vsnk = VectorSink(np.float32)
        fg.connect(VectorSource(host), kern, vsnk)
        rt = Runtime()
        running = rt.start(fg)
        deadline = time.monotonic() + 60
        while kern.frames_dispatched < 4:
            check(time.monotonic() < deadline, f"fm retune {chain}: stream did not start")
            time.sleep(0.0005)
        at = kern.apply_retune("tuner", phase_inc=theta2)
        running.wait_sync()
        rt.shutdown()
        check(0 < at < n_frames, f"fm retune {chain}: landed at frame {at} of "
                                 f"{n_frames}, not mid-stream")
        pipe = Pipeline(fm_stages(chain), np.complex64)
        fn, carry = pipe.fn(), pipe.init_carry(dev)
        outs = []
        for i in range(n_frames):
            if i == at:
                carry = pipe.update_stage(carry, "tuner", phase_inc=theta2)
            carry, y = fn(carry, torch.from_numpy(host[i * frame:(i + 1) * frame]).to(dev))
            outs.append(y)
        got = torch.from_numpy(vsnk.items())
        ref = torch.cat(outs).cpu()
        check(got.shape == ref.shape, f"fm retune {chain}: {tuple(got.shape)} items, "
                                      f"want {tuple(ref.shape)}")
        err = max_abs(got, ref)
        print(f"fm retune {chain}: tuner retuned at frame {at} of {n_frames}; vs "
              f"resident chain with the same retune {err:.3e} (tol {CHAIN_TOL:g})")
        check(err <= CHAIN_TOL, f"fm retune {chain}: differs by {err:.3e}")


def kernels_a_frame(stages, frames, dev) -> list:
    """The kernels one resident frame launches on the card, by
    ``torch.profiler``: ``Pipeline(stages).fn`` over ``frames[:-1]`` to warm
    up, then the last frame profiled (copies and memsets not counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from futuresdr_tpu_torch.ops.stages import Pipeline
    pipe = Pipeline(stages, np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    for x in frames[:-1]:
        carry, _ = fn(carry, x)
    torch.cuda.synchronize()
    # torch.cuda._sleep's spin_kernel marks a profile that recorded the card
    # at all: now and then CUPTI records nothing, which is not zero kernels
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            fn(carry, frames[-1])
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        if any("spin_kernel" in n for n in names):
            return [n for n in names if "spin_kernel" not in n]
        print(f"profile: the profiler recorded no kernel, not even its marker "
              f"(attempt {attempt + 1} of 3)")
    raise SmokeError("the profiler recorded no kernel in 3 attempts")


def phase_fm_kernel_count(dev) -> None:
    """Kernels a frame of the FM kernel chain and of its rotator stage alone
    (``torch.profiler`` over one 512,000-sample frame): the stage launches
    one kernel a frame, which also writes the next phase."""
    from futuresdr_tpu_torch.ops.stages import rotator_stage
    frames = list(fm_iq(3 * FM_FRAMES[0], dev).split(FM_FRAMES[0]))
    counts = {}
    for label, stages in (("kernel chain", fm_stages("kernel")),
                          ("rotator stage", [rotator_stage(FM_THETA, name="tuner",
                                                           impl="pallas")])):
        names = kernels_a_frame(stages, frames, dev)
        counts[label] = len(names)
        short = [n.replace("void ", "").replace("(anonymous namespace)::", "")
                 .split("<")[0].split("(")[0] for n in names]
        print(f"profile fm {label} frame={FM_FRAMES[0]}: {len(names)} kernels a frame "
              f"({', '.join(short)})")
    check(counts["rotator stage"] == 1, f"rotator_stage(impl='pallas') launches "
                                        f"{counts['rotator stage']} kernels a frame, not 1")


def phase_fm_wav(dev, wav_path) -> float:
    """The app as a user builds it: ``build_flowgraph(VectorSource(iq),
    use_tpu=True, audio_path=…)``; returns the WAV's spectral peak in Hz."""
    import wave

    from futuresdr_tpu_torch import Runtime
    from futuresdr_tpu_torch.apps.fm_receiver import AUDIO_RATE, build_flowgraph
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.tpu import TpuInstance
    n = FM_WAV_SAMPLES
    iq = fm_iq(n, dev).cpu().numpy()
    fg, _, sink = build_flowgraph(VectorSource(iq), input_rate=FM_RATE,
                                  offset=FM_OFFSET, audio_path=str(wav_path),
                                  use_tpu=True, inst=TpuInstance(dev))
    Runtime().run(fg)
    want = (n - n % 500) * 24 // 500
    check(sink.n_written == want, f"fm wav: {sink.n_written} samples, want {want}")
    w = wave.open(str(wav_path), "rb")
    pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float64)
    w.close()
    pcm = pcm[len(pcm) // 4:]                    # skip the transient
    spec = np.abs(np.fft.rfft(pcm * np.hanning(len(pcm))))
    peak = float(np.fft.rfftfreq(len(pcm), 1.0 / AUDIO_RATE)[np.argmax(spec[5:]) + 5])
    print(f"fm wav: {sink.n_written} samples at {AUDIO_RATE} Hz, spectral peak "
          f"{peak:.1f} Hz (want 1000 +- 20)")
    check(abs(peak - 1000.0) < 20.0, f"fm wav: tone at {peak:.1f} Hz, not 1 kHz")
    return peak


def start_empty_kernel(build_dir):
    """Start ``nvcc`` on ``EMPTY_CU`` (the empty kernel and the ACS step
    chain) into ``build_dir``, with the port's flags; returns a function that
    waits for it and gives the loaded library."""
    from futuresdr_tpu_torch.ops import _build
    build_dir.mkdir(parents=True, exist_ok=True)
    src = build_dir / "empty_launch.cu"
    so = build_dir / "libempty_launch.so"
    src.write_text(EMPTY_CU)
    proc = subprocess.Popen([_build._nvcc(), *_build.FLAGS, "-o", str(so), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed for the empty kernel:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.fsdr_empty.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
        lib.fsdr_empty.restype = ctypes.c_int
        vp = ctypes.c_void_p
        lib.fsdr_acs_chain.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
        lib.fsdr_acs_chain.restype = ctypes.c_int
        return lib
    return finish


def fm_kernel_timings(dev, f: int, empty_lib) -> dict:
    """Kernel, plain and library device time and the bound of each FM kernel
    on the kernel chain's calls at input frame ``f``: the rotator on ``f``
    samples, the channel ``poly_fir`` on ``f`` (D = 4, m = 32, complex64),
    the demod on ``f/4``, the resampler ``poly_fir`` on ``f/4`` (D = 125,
    I = 24, m = 2, float32). ``poly_fir``'s entry is its two calls per frame
    summed; ``calls`` keeps each."""
    import torch
    import torch.nn.functional as F

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    n4 = f // 4
    ph0 = torch.tensor(1.25, dtype=torch.float32, device=dev)
    inc = torch.tensor(FM_THETA, dtype=torch.float32, device=dev)
    # the weights' values do not change the kernels' work: random, at the
    # shapes of the chain's W (channel [33, 4], resampler [3, 125, 24])
    w2 = torch.randn(33, 4, generator=gen, device=dev)
    w3 = torch.randn(3, 125, 24, generator=gen, device=dev)
    reps = REPS
    rot_args = [(randc(f, gen, dev),) for _ in range(reps)]
    chan_args = [(randc(128, gen, dev), randc(f, gen, dev)) for _ in range(reps)]
    dem_args = [(randc(1, gen, dev).reshape(()), randc(n4, gen, dev)) for _ in range(reps)]
    res_args = [(torch.randn(250, generator=gen, device=dev),
                 torch.randn(n4, generator=gen, device=dev)) for _ in range(reps)]
    # library yardsticks, timed here only and never called by the port:
    # conv1d over the row layout (in-channels D, kernel m+1, out-channels I)
    cw2 = w2.flip(0).t().unsqueeze(0).contiguous()            # [1, 4, 33]
    cw3 = w3.flip(0).permute(2, 1, 0).contiguous()            # [24, 125, 3]
    chan_lib = [(torch.view_as_real(torch.cat([h, x])).reshape(-1, 4, 2)
                 .permute(2, 1, 0).contiguous(),) for h, x in chan_args]
    res_lib = [(torch.cat([h, x]).reshape(-1, 125).t().unsqueeze(0).contiguous(),)
               for h, x in res_args]
    # yardsticks, timed here only and never called by the port: a kernel with
    # no body on the kernel's grid (256 threads a block, one block a tile),
    # and a PyTorch copy of the kernel's bytes (the complex frame; the demod's
    # real plane into float32)
    def empty(tile, n):
        def launch(*args):
            ck._raise_on(empty_lib.fsdr_empty(-(-n // tile), 256, ck._stream(args[-1])),
                         "empty")
        return launch

    yard = {
        "rotator": (empty(ck.ROTATOR_TILE, f), lambda x, y: y.copy_(x),
                    [(x, torch.empty_like(x)) for x, in rot_args]),
        "quad_demod": (empty(ck.QUAD_DEMOD_TILE, n4), lambda x, y: y.copy_(x.real),
                       [(x, torch.empty(n4, device=dev)) for _, x in dem_args]),
    }
    plan = {
        "rotator": (lambda x: ck.rotator(x, ph0, inc),
                    lambda x: ck.rotator_plain(x, ph0, inc), None, rot_args, None,
                    16 * f + 8, 8 * f),
        "quad_demod": (lambda p, x: ck.quad_demod(p, x, FM_GAIN),
                       lambda p, x: ck.quad_demod_plain(p, x, FM_GAIN), None,
                       dem_args, None, 12 * n4 + 16, 7 * n4),
        "poly_fir/channel": (lambda h, x: ck.poly_fir(h, x, w2),
                             lambda h, x: ck.poly_fir_plain(h, x, w2),
                             lambda p: F.conv1d(p, cw2), chan_args, chan_lib,
                             8 * (f + 128) + 4 * w2.numel() + 8 * n4,
                             4 * w2.numel() * n4),
        "poly_fir/resampler": (lambda h, x: ck.poly_fir(h, x, w3),
                               lambda h, x: ck.poly_fir_plain(h, x, w3),
                               lambda p: F.conv1d(p, cw3), res_args, res_lib,
                               4 * (n4 + 250) + 4 * w3.numel() + 4 * (n4 // 125) * 24,
                               2 * w3.numel() * (n4 // 125)),
    }
    out = {}
    for name, (kern, plain, lib, args, lib_args, nbytes, flops) in plan.items():
        got, ref = kern(*args[0]), plain(*args[0])
        if name == "quad_demod":
            err = demod_err(got[0], ref[0])
        elif name == "rotator":
            err, _ = rel_err(got[0], ref[0])
        else:
            err, _ = rel_err(got, ref)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
        out[name] = {
            "ms": device_ms(kern, args), "plain_ms": device_ms(plain, args),
            "library_ms": device_ms(lib, lib_args) if lib else None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err}
        if name in yard:
            empty, copy, copy_args = yard[name]
            out[name].update(empty_ms=device_ms(empty, args),
                             copy_ms=device_ms(copy, copy_args))
    ch, rs = out.pop("poly_fir/channel"), out.pop("poly_fir/resampler")
    out["poly_fir"] = {k: ch[k] + rs[k] for k in ("ms", "plain_ms", "library_ms",
                                                   "bound_ms")}
    out["poly_fir"].update(
        max_abs_err=max(ch["max_abs_err"], rs["max_abs_err"]),
        bound_by=max(ch, rs, key=lambda c: c["bound_ms"])["bound_by"],
        calls={"channel": ch, "resampler": rs})
    return out


# ---------------------------------------------------------------------------
# phases 12-15: the PFB channelizer and the spectrum app
# ---------------------------------------------------------------------------

def pfb_branch(dev, precision=None, atten_db: float = 70.0, n: int = PFB_N):
    """The channelizer stage's carried taps for PFB-``n``, ``[N, K]``."""
    from futuresdr_tpu_torch.ops.stages import channelizer_stage
    from futuresdr_tpu_torch.blocks import pfb_default_taps
    st = channelizer_stage(n, pfb_default_taps(n, atten_db=atten_db),
                           precision=precision)
    return st.init_carry(np.complex64, dev)[0]


class _PfbCall:
    """A ``pfb`` call on fixed inputs; ``f32_mode()`` runs the kernel on the
    same inputs with its bf16 mode off."""

    def __init__(self, fn, hist, x, taps, precision):
        self.fn, self.args, self.precision = fn, (hist, x, taps), precision

    def __call__(self):
        return self.fn(*self.args, self.precision)

    def f32_mode(self):
        return self.fn(*self.args, None)


def pfb_kernel_cases(dev):
    """(kernel, label, kernel call, plain call) for ``pfb`` at PFB-64, ragged
    t, other channel counts and one tap a branch; the taps go in as the
    stage passes them, its ``[N, K]`` carry transposed."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    cases = []
    for n, t in ((PFB_N, PFB_FRAMES[0] // PFB_N), (PFB_WIDE_N, 64)):
        for prec in (None, "bf16"):
            hc = pfb_branch(dev, prec, n=n)
            K = hc.shape[1]
            hist, x = randc((K - 1) * n, gen, dev), randc(t * n, gen, dev)
            cases.append(("pfb", f"pfb PFB-{n} t={t} K={K} {prec or 'f32'}",
                          _PfbCall(ck.pfb, hist, x, hc.t(), prec),
                          _PfbCall(ck.pfb_plain, hist, x, hc.t(), prec)))
    for t, K, N in ((1, 12, 64), (37, 12, 64), (500, 12, 5), (300, 12, 24),
                    (64, 12, 1024), (9, 12, 4096), (7, 12, 1000), (300, 1, 64)):
        w = torch.randn(N, K, generator=gen, device=dev)
        hist, x = randc((K - 1) * N, gen, dev), randc(t * N, gen, dev)
        cases.append(("pfb", f"pfb t={t} K={K} N={N} f32",
                      lambda h=hist, x=x, w=w: ck.pfb(h, x, w.t()),
                      lambda h=hist, x=x, w=w: ck.pfb_plain(h, x, w.t())))
    # the "v" layout, which the plan keeps for rows too wide to stage, forced
    # at N = 2048 (radix 2) and N = 1000 (direct DFT)
    for N in (2048, 1000):
        t, K = 5, 12
        w = torch.randn(N, K, generator=gen, device=dev)
        hist, x = randc((K - 1) * N, gen, dev), randc(t * N, gen, dev)
        plan = ck.PfbPlan(False, 256, N, 1, 1, 1, 0, (), (), (), N, N, ck._NO_PAD, False,
                          8 * N)
        cases.append(("pfb", f"pfb t={t} K={K} N={N} f32 (v layout)",
                      lambda h=hist, x=x, w=w, p=plan, N=N, t=t: ck._launch_pfb(
                          h, x, w.t(), torch.empty((t, N), dtype=torch.complex64,
                                                   device=x.device), False, p),
                      lambda h=hist, x=x, w=w: ck.pfb_plain(h, x, w.t())))
    return cases


def pfb_stages(impl: str, atten_db: float = 70.0, n: int = PFB_N):
    from futuresdr_tpu_torch.blocks import pfb_default_taps
    from futuresdr_tpu_torch.ops.stages import channelizer_stage
    return [channelizer_stage(n, pfb_default_taps(n, atten_db=atten_db), impl=impl)]


PFB_IMPLS = ("matmul", "pallas")


def run_pfb(impl, frames, dev, n: int = PFB_N):
    import torch

    from futuresdr_tpu_torch.ops.stages import Pipeline
    pipe = Pipeline(pfb_stages(impl, n=n), np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for x in frames:
        carry, y = fn(carry, x)
        outs.append(y)
    return torch.cat(outs)


def tone_powers(y, n: int, skip: int = 16) -> np.ndarray:
    """Mean power of each channel of the interleaved output after ``skip``
    rows (past the prototype's K = 12 rows of transient)."""
    return (y.reshape(-1, n)[skip:].abs() ** 2).mean(dim=0).double().cpu().numpy()


def phase_pfb_resident(dev) -> dict:
    """Both routes at each frame, 8 frames chained; returns Msps per (route,
    frame)."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops.stages import Pipeline
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rates = {}
    # the stage's default route on a carry on the card: the kernel
    for n, ref_impl in ((PFB_N, "pallas"), (PFB_WIDE_N, "matmul")):
        xs = [randc(PFB_FRAMES[0], gen, dev) for _ in range(2)]
        before = ck.launches["pfb"]
        got = run_pfb("auto", xs, dev, n)
        torch.cuda.synchronize()
        launched = ck.launches["pfb"] - before
        ref = run_pfb(ref_impl, xs, dev, n)
        check(launched == len(xs), f"pfb auto N={n}: {launched} kernel launches for "
                                   f"{len(xs)} frames")
        if ref_impl == "pallas":
            check(torch.equal(got, ref), f"pfb auto N={n}: differs from the pallas route")
            print(f"pfb auto N={n}: {launched} launches, equal to the pallas route")
        else:
            snr = snr_db(got, ref)
            print(f"pfb auto N={n}: {launched} launches, {snr:.1f} dB against the "
                  f"matmul route (min {PFB_ROUTE_SNR:g})")
            check(snr >= PFB_ROUTE_SNR, f"pfb auto N={n}: {snr:.1f} dB against matmul")
        del xs, got, ref
    for f in PFB_FRAMES:
        xs = [randc(f, gen, dev) for _ in range(PFB_CHAIN)]
        out = {}
        for impl in PFB_IMPLS:
            chained = run_pfb(impl, xs, dev)
            long_ = run_pfb(impl, [torch.cat(xs)], dev)
            check(chained.shape == (PFB_CHAIN * f,) and chained.dtype == torch.complex64,
                  f"pfb resident {impl}: output {tuple(chained.shape)} {chained.dtype}")
            check(bool(torch.isfinite(torch.view_as_real(chained)).all()),
                  f"pfb resident {impl}: non-finite")
            _, rel = rel_err(chained, long_)
            print(f"pfb resident {impl} frame={f}: {PFB_CHAIN} chained vs one long "
                  f"frame {rel:.3e} of peak (tol {CHAIN_TOL:g})")
            check(rel <= CHAIN_TOL, f"pfb resident {impl} frame={f}: chained frames "
                                    f"differ from one long frame by {rel:.3e}")
            out[impl] = chained
            del long_
        snr = snr_db(out["pallas"], out["matmul"])
        print(f"pfb resident frame={f}: pallas vs matmul route {snr:.1f} dB "
              f"(min {PFB_ROUTE_SNR:g})")
        check(snr >= PFB_ROUTE_SNR, f"pfb frame={f}: routes agree to {snr:.1f} dB only")
        del out
        for impl in PFB_IMPLS:
            pipe = Pipeline(pfb_stages(impl), np.complex64)
            fn, state = pipe.fn(), [pipe.init_carry(dev)]

            def step(fn=fn, state=state, xs=xs):
                c = state[0]
                for x in xs:
                    c, _ = fn(c, x)
                state[0] = c

            ms = cuda_ms(step)
            rates[(impl, f)] = PFB_CHAIN * f / (ms * 1e-3) / 1e6
        del xs
    # a tone at channel c's centre lands in output c
    n = torch.arange(PFB_FRAMES[0], dtype=torch.float64, device=dev)
    for c in PFB_TONE_CHANNELS:
        x = torch.polar(torch.ones_like(n), 2 * np.pi * (c / PFB_N) * n).to(torch.complex64)
        p = tone_powers(run_pfb("pallas", [x], dev), PFB_N)
        ratio = p[c] / np.delete(p, c).max()
        print(f"pfb tone at channel {c}: strongest output {int(np.argmax(p))}, "
              f"{ratio:.3g}x the next (min {PFB_TONE_RATIO:g})")
        check(int(np.argmax(p)) == c and ratio >= PFB_TONE_RATIO,
              f"pfb tone at channel {c}: output {int(np.argmax(p))}, ratio {ratio:.3g}")
    return rates


def _pfb_kernel_block(frame, dev, impl="pallas"):
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    return TpuKernel(pfb_stages(impl), np.complex64, frame_size=frame,
                     inst=TpuInstance(dev), frames_in_flight=IN_FLIGHT, wire=LINK)


def phase_pfb_streamed(dev) -> float:
    """NullSource -> Head -> TpuKernel -> NullSink (rate), then VectorSource ->
    TpuKernel -> StreamDeinterleaver(64) -> 64 VectorSinks against the
    resident chain and the host PfbChannelizer block; returns streamed Msps."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, PfbChannelizer,
                                            StreamDeinterleaver, VectorSink,
                                            VectorSource, pfb_default_taps)
    frame = PFB_FRAMES[0]
    n_items = PFB_STREAM_FRAMES * frame
    runs = []
    for _ in range(STREAM_RUNS):
        fg = Flowgraph()
        snk = NullSink(np.complex64)
        fg.connect(NullSource(np.complex64), Head(np.complex64, n_items),
                   _pfb_kernel_block(frame, dev), snk)
        rt = Runtime()
        t0 = time.perf_counter()
        rt.run(fg)
        runs.append(time.perf_counter() - t0)
        rt.shutdown()
        check(snk.n_received == n_items,
              f"pfb streamed: NullSink got {snk.n_received} items, want {n_items}")
    rate = n_items / statistics.median(runs) / 1e6
    print(f"pfb streamed: {n_items} items through NullSource -> Head -> TpuKernel -> "
          f"NullSink in {', '.join(f'{t:.3f}' for t in runs)} s")

    # deinterleaved, ending in a partial frame
    rng = np.random.default_rng(SEED + 22)
    n_host = PFB_VECTOR_FRAMES * frame + 3 * PFB_N + 5
    host = (rng.standard_normal(n_host) + 1j * rng.standard_normal(n_host)).astype(np.complex64)
    fg = Flowgraph()
    dein = StreamDeinterleaver(np.complex64, PFB_N)
    sinks = [VectorSink(np.complex64) for _ in range(PFB_N)]
    fg.connect(VectorSource(host), _pfb_kernel_block(frame, dev), dein)
    for i, s in enumerate(sinks):
        fg.connect_stream(dein, f"out{i}", s, "in")
    Runtime().run(fg)
    got = np.stack([s.items() for s in sinks], axis=1)          # [t, N]
    t_out = n_host // PFB_N
    check(got.shape == (t_out, PFB_N), f"pfb vector: {got.shape}, want {(t_out, PFB_N)}")
    padded = np.zeros((PFB_VECTOR_FRAMES + 1) * frame, np.complex64)
    padded[:n_host] = host
    xs = [torch.from_numpy(padded[i * frame:(i + 1) * frame]).to(dev)
          for i in range(PFB_VECTOR_FRAMES + 1)]
    res = run_pfb("pallas", xs, dev)[:t_out * PFB_N].reshape(t_out, PFB_N)
    _, rel = rel_err(torch.from_numpy(got), res)
    print(f"pfb vector: {PFB_N} channels of {t_out} samples, vs resident chain "
          f"{rel:.3e} of peak (tol {CHAIN_TOL:g})")
    check(rel <= CHAIN_TOL, f"pfb vector: differs from the resident chain by {rel:.3e}")

    host_fg = Flowgraph()
    chan = PfbChannelizer(PFB_N, pfb_default_taps(PFB_N))
    hsinks = [VectorSink(np.complex64) for _ in range(PFB_N)]
    host_fg.connect(VectorSource(host), chan)
    for i, s in enumerate(hsinks):
        host_fg.connect_stream(chan, f"out{i}", s, "in")
    Runtime().run(host_fg)
    ref = np.stack([s.items() for s in hsinks], axis=1)
    check(ref.shape == got.shape, f"pfb host block: {ref.shape}, want {got.shape}")
    bound = PFB_BLOCK_ATOL * np.abs(ref).max() + PFB_BLOCK_RTOL * np.abs(ref)
    excess = float(np.max(np.abs(got.astype(np.complex128) - ref) - bound))
    err = float(np.max(np.abs(got.astype(np.complex128) - ref)))
    print(f"pfb vector vs host PfbChannelizer block: max_abs_err {err:.3e} "
          f"(rtol {PFB_BLOCK_RTOL:g}, atol {PFB_BLOCK_ATOL:g} of peak)")
    check(excess <= 0, f"pfb vector: differs from the host block beyond tolerance")
    return rate


def phase_pfb_retune(dev) -> None:
    """Swap the prototype (70 dB → 50 dB Kaiser, same K) while frames stream;
    the output must equal the resident chain with the swap at the frame the
    kernel reports."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource, pfb_default_taps
    from futuresdr_tpu_torch.ops.stages import Pipeline
    frame, n_frames = PFB_FRAMES[0], 16
    taps2 = pfb_default_taps(PFB_N, atten_db=50.0)
    rng = np.random.default_rng(SEED + 23)
    host = (rng.standard_normal(n_frames * frame)
            + 1j * rng.standard_normal(n_frames * frame)).astype(np.complex64)
    kern = _pfb_kernel_block(frame, dev)
    fg = Flowgraph()
    vsnk = VectorSink(np.complex64)
    fg.connect(VectorSource(host), kern, vsnk)
    rt = Runtime()
    running = rt.start(fg)
    deadline = time.monotonic() + 60
    while kern.frames_dispatched < 4:
        check(time.monotonic() < deadline, "pfb retune: stream did not start")
        time.sleep(0.0005)
    at = kern.apply_retune(0, taps=taps2)
    running.wait_sync()
    rt.shutdown()
    check(0 < at < n_frames, f"pfb retune: landed at frame {at} of {n_frames}")
    pipe = Pipeline(pfb_stages("pallas"), np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for i in range(n_frames):
        if i == at:
            carry = pipe.update_stage(carry, 0, taps=taps2)
        carry, y = fn(carry, torch.from_numpy(host[i * frame:(i + 1) * frame]).to(dev))
        outs.append(y)
    _, rel = rel_err(torch.from_numpy(vsnk.items()), torch.cat(outs))
    print(f"pfb retune: prototype swapped at frame {at} of {n_frames}; vs resident "
          f"chain with the same swap {rel:.3e} of peak")
    check(rel <= CHAIN_TOL, f"pfb retune: differs by {rel:.3e}")


def phase_spectrum_app(dev) -> float:
    """``build_flowgraph(VectorSource(tone), use_tpu=True, collect=True)``: the
    last spectrum's peak in the tone's bin, every spectrum against a float64
    recomputation (FFT, |x|², EMA, 10·log10); returns the streamed input
    Msamples/s."""
    import torch

    from futuresdr_tpu_torch import Runtime
    from futuresdr_tpu_torch.apps.spectrum import FFT_SIZE, build_flowgraph
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.tpu import TpuInstance
    fft = FFT_SIZE
    frame = max(16 * fft, 1 << 15)
    n = SPEC_FRAMES * frame
    rng = np.random.default_rng(SEED + 24)
    tone = (np.exp(2j * np.pi * SPEC_TONE * np.arange(n))
            + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)
    from futuresdr_tpu_torch.config import config
    # the app's kernel resolves the configured wire: f32 here (LINK), since
    # the float64 comparison's tolerance was set for a float32 link
    saved, config().tpu_wire_format = config().tpu_wire_format, LINK
    try:
        fg, sink = build_flowgraph(VectorSource(tone), use_tpu=True, collect=True,
                                   inst=TpuInstance(dev))
    finally:
        config().tpu_wire_format = saved
    t0 = time.perf_counter()
    Runtime().run(fg)
    wall = time.perf_counter() - t0
    got = sink.items()
    check(got.shape == (n,) and got.dtype == np.float32,
          f"spectrum app: {got.shape} {got.dtype}, want ({n},) float32")
    check(bool(np.isfinite(got).all()), "spectrum app: non-finite output")
    peak = int(np.argmax(got[-fft:]))
    print(f"spectrum app: {n} samples, last spectrum peaks in bin {peak} "
          f"(want {round(SPEC_TONE * fft)})")
    check(peak == round(SPEC_TONE * fft), f"spectrum app: peak in bin {peak}")
    rows = torch.from_numpy(tone).to(dev).to(torch.complex128).reshape(-1, fft)
    p = torch.fft.fft(rows, dim=1).abs() ** 2
    c = torch.zeros(fft, dtype=torch.float64, device=dev)
    ema = []
    for r in p:
        c = c * (1.0 - 0.1) + r * 0.1
        ema.append(c)
    ema = torch.stack(ema)
    ref = 10 * torch.log10(torch.clamp_min(ema, 1e-20))
    got_db = torch.from_numpy(got).to(dev).double().reshape(-1, fft)
    err = float((got_db[SPEC_SETTLE:] - ref[SPEC_SETTLE:]).abs().max())
    head = (10 ** (got_db[:SPEC_SETTLE] / 10) - ema[:SPEC_SETTLE]).abs().amax(dim=1)
    rel = float((head / ema[:SPEC_SETTLE].amax(dim=1)).max())
    print(f"spectrum app vs float64 recomputation: max {err:.3e} dB after "
          f"{SPEC_SETTLE} spectra (tol {SPEC_DB_TOL:g}), {rel:.3e} of the peak power "
          f"before (tol {SPEC_POWER_TOL:g})")
    check(err <= SPEC_DB_TOL, f"spectrum app: differs by {err:.3e} dB")
    check(rel <= SPEC_POWER_TOL, f"spectrum app: first spectra differ by {rel:.3e}")
    return n / wall / 1e6


def pfb_timings(dev, n: int, n_ch: int = PFB_N) -> dict:
    """Kernel, plain and matmul-route device time and the bound of ``pfb`` at
    PFB-``n_ch`` on a frame of ``n`` samples."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops.stages import _pfb_matmul
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    hc = pfb_branch(dev, n=n_ch)
    K = hc.shape[1]
    # REPS distinct frames per graph: 20 x 16 B x 2^18 = 84 MB > L2
    args = [(randc((K - 1) * n_ch, gen, dev), randc(n, gen, dev)) for _ in range(REPS)]
    nbytes = 8 * (K - 1) * n_ch + 16 * n + 4 * K * n_ch + 8 * n_ch
    flops = n * (4 * K + 5 * int(np.log2(n_ch)))

    def kern(h, x):
        return ck.pfb(h, x, hc.t())

    def plain(h, x):
        return ck.pfb_plain(h, x, hc.t())

    def lib(h, x):                  # the matmul route, timed here only
        return _pfb_matmul(h, x, hc)

    err, _ = rel_err(kern(*args[0]), plain(*args[0]))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return {"ms": device_ms(kern, args), "plain_ms": device_ms(plain, args),
            "library_ms": device_ms(lib, args), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err}


# ---------------------------------------------------------------------------
# phases 16-17: the host side of the main path (compiled replay, megabatch K,
# the pinned staging arena)
# ---------------------------------------------------------------------------

def host_chains(taps) -> list:
    """``(label, stages factory, frames, its hand kernels)`` of every chain
    the host phases drive, at the frames the rate phases use."""
    from futuresdr_tpu_torch.apps.spectrum import spectrum_stages
    return [("spectrum os", lambda: chain_stages("os", taps), FRAMES, ()),
            ("spectrum pallas", lambda: chain_stages("pallas", taps), FRAMES, ("fir",)),
            ("spectrum fused", lambda: chain_stages("fused", taps), FRAMES, ("fir_fft",)),
            ("spectrum app", lambda: spectrum_stages(N_FFT), (1 << 15,), ()),
            ("fm app", lambda: fm_stages("app"), FM_FRAMES, ()),
            ("fm kernel", lambda: fm_stages("kernel"), FM_FRAMES, FM_KERNELS),
            ("fm plain", lambda: fm_stages("plain"), FM_FRAMES, ()),
            ("pfb matmul", lambda: pfb_stages("matmul"), PFB_FRAMES, ()),
            ("pfb pallas", lambda: pfb_stages("pallas"), PFB_FRAMES, PFB_KERNELS)]


def host_input(label: str, n: int, gen, dev):
    return fm_iq(n, dev) if label.startswith("fm ") else randc(n, gen, dev)


def run_compiled(fn, carry, frames, k: int, pipe=None, retune=None):
    """``fn`` (from ``Pipeline.compile(k=k)``) over ``frames``, ``k`` a
    dispatch; ``retune = (frame, stage, params)`` goes through
    ``pipe.update_stage`` on the compiled carry before that frame's
    dispatch. Returns the outputs flattened."""
    import torch
    outs = []
    for d in range(len(frames) // k):
        if retune is not None and d * k == retune[0]:
            carry = pipe.update_stage(carry, retune[1], **retune[2])
        x = torch.stack(frames[d * k:(d + 1) * k]) if k > 1 else frames[d]
        carry, y = fn(carry, x)
        outs.append(y.reshape(-1))
    return torch.cat(outs)


def run_eager(pipe, frames, dev, retune=None):
    """``pipe.fn`` over ``frames``, carry chained, the same ``retune``."""
    import torch
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for i, x in enumerate(frames):
        if retune is not None and i == retune[0]:
            carry = pipe.update_stage(carry, retune[1], **retune[2])
        carry, y = fn(carry, x)
        outs.append(y.reshape(-1))
    return torch.cat(outs)


def card_ms(fn) -> float:
    """The card's time for ``fn()`` (a run of calls): its work queued behind
    a device sleep, so the host has enqueued all of it before the card
    starts; median of 5, ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_compiled(dev, taps) -> dict:
    """Every chain at each of its frames: ``Pipeline.compile`` at K = 1 and
    4 against the eager chain over HOST_DISPATCHES chained dispatches
    (CHAIN_TOL of the peak), one capture each, each replay adding the
    launches its graph recorded; then the resident rate of the eager chain
    and of each compiled K over the same 12 frames beside the card's time
    for them. Returns ``{(label, frame): {mode: (Msps, card µs a frame)}}``."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops.stages import Pipeline
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    n_frames = HOST_DISPATCHES * max(HOST_K)
    rates = {}
    for label, make, frames, kernels in host_chains(taps):
        for f in frames:
            x_all = host_input(label, n_frames * f, gen, dev)
            xs = list(x_all.split(f))
            pipe = Pipeline(make(), np.complex64)
            ref = run_eager(pipe, xs, dev)
            eager, eager_state = pipe.fn(), [pipe.init_carry(dev)]

            def eager_step(fn=eager, state=eager_state, xs=xs):
                c = state[0]
                for x in xs:
                    c, _ = fn(c, x)
                state[0] = c

            modes = {"eager": eager_step}
            for k in HOST_K:
                fn, carry = pipe.compile(f, dev, k=k)
                for kern in kernels:
                    check(fn.launches.get(kern, 0) >= k, f"compiled {label} frame={f} "
                          f"K={k}: the graph holds no {kern} launch a frame")
                before = dict(ck.launches)
                got = run_compiled(fn, carry, xs[:HOST_DISPATCHES * k], k)
                torch.cuda.synchronize()
                added = {n: ck.launches[n] - before[n] for n in ck.launches}
                check(added == {n: HOST_DISPATCHES * fn.launches.get(n, 0) for n in added},
                      f"compiled {label} K={k}: replays added {added}, the graph "
                      f"holds {fn.launches}")
                check(fn.captures == 1, f"compiled {label} K={k}: {fn.captures} captures")
                check(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                          else got).all()), f"compiled {label}: non-finite")
                _, rel = rel_err(got, ref[:got.shape[0]])
                print(f"compiled {label} frame={f} K={k}: {HOST_DISPATCHES} replays vs "
                      f"eager {rel:.3e} of peak (tol {CHAIN_TOL:g}), launches a replay "
                      f"{fn.launches}")
                check(rel <= CHAIN_TOL, f"compiled {label} frame={f} K={k}: differs from "
                                        f"eager by {rel:.3e}")
                state = [carry]
                # the dispatches' inputs as views of the one input tensor
                groups = list(x_all.view(-1, k, f)) if k > 1 else xs

                def step(fn=fn, state=state, groups=groups):
                    c = state[0]
                    for x in groups:
                        c, _ = fn(c, x)
                    state[0] = c

                modes[f"K={k}"] = step
            rates[(label, f)] = {
                m: (n_frames * f / (cuda_ms(run, 5) * 1e-3) / 1e6,
                    card_ms(run) * 1e3 / n_frames) for m, run in modes.items()}
            del x_all, xs, ref, modes
    return rates


def phase_compiled_retune(dev, taps) -> None:
    """A retune between dispatches through the compiled carry (the FIR taps,
    the FM tuner's phase_inc, the PFB prototype): no new capture, and the
    output equals the eager chain retuned at the same frame."""
    import torch

    from futuresdr_tpu_torch.blocks import pfb_default_taps
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import Pipeline
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    cases = [("spectrum pallas", 0, {"taps": firdes.lowpass(0.05, N_TAPS).astype(np.float32)}),
             ("spectrum fused", 0, {"taps": firdes.lowpass(0.05, N_TAPS).astype(np.float32)}),
             ("fm app", "tuner", {"phase_inc": -2 * np.pi * 150e3 / FM_RATE}),
             ("fm kernel", "tuner", {"phase_inc": -2 * np.pi * 150e3 / FM_RATE}),
             ("pfb pallas", 0, {"taps": pfb_default_taps(PFB_N, atten_db=50.0)})]
    chains = {label: (make, frames) for label, make, frames, _ in host_chains(taps)}
    for label, stage, params in cases:
        make, frames = chains[label]
        f = frames[0]
        xs = list(host_input(label, 4 * f, gen, dev).split(f))
        pipe = Pipeline(make(), np.complex64)
        fn, carry = pipe.compile(f, dev, k=2)
        got = run_compiled(fn, carry, xs, 2, pipe, retune=(2, stage, params))
        check(fn.captures == 1, f"compiled retune {label}: {fn.captures} captures")
        ref = run_eager(pipe, xs, dev, retune=(2, stage, params))
        _, rel = rel_err(got, ref)
        print(f"compiled retune {label} ({', '.join(params)}) at frame 2 of 4, K=2: "
              f"{fn.captures} capture, vs eager with the same retune {rel:.3e} of peak "
              f"(tol {CHAIN_TOL:g})")
        check(rel <= CHAIN_TOL, f"compiled retune {label}: differs by {rel:.3e}")


def _host_kernel_block(label, make, frame, dev, k):
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    return TpuKernel(make(), np.complex64, frame_size=frame, inst=TpuInstance(dev),
                     frames_in_flight=IN_FLIGHT, frames_per_dispatch=k, wire=LINK)


def phase_megabatch_streamed(dev, taps) -> dict:
    """The streamed chains at K = 4 against K = 1: ``VectorSource ->
    TpuKernel -> VectorSink`` over 11 frames and a partial one (the last
    group partial at EOS) gives the same items, equal at CHAIN_TOL; then
    ``NullSource -> Head -> TpuKernel -> NullSink`` at each K (median of
    STREAM_RUNS) and the arena's hits and misses. Returns streamed Msps per
    (label, frame, K)."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, VectorSink,
                                            VectorSource)
    from futuresdr_tpu_torch.ops.arena import arena
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    rates = {}
    for label, make, frames, _ in host_chains(taps):
        if label in ("spectrum os", "spectrum app", "fm plain", "pfb matmul"):
            continue
        f = frames[0]
        host = host_input(label, 11 * f + f // 3 + 7, gen, dev).cpu().numpy()
        out = {}
        for k in HOST_K:
            kern = _host_kernel_block(label, make, f, dev, k)
            fg = Flowgraph()
            vsnk = VectorSink(kern.pipeline.out_dtype)
            fg.connect(VectorSource(host), kern, vsnk)
            rt = Runtime()
            rt.run(fg)
            rt.shutdown()
            out[k] = torch.from_numpy(vsnk.items())
            check(kern.frames_dispatched == 12, f"megabatch {label} K={k}: "
                  f"{kern.frames_dispatched} frames dispatched, want 12")
        check(out[4].shape == out[1].shape, f"megabatch {label}: K=4 gave "
              f"{tuple(out[4].shape)} items, K=1 {tuple(out[1].shape)}")
        _, rel = rel_err(out[4], out[1])
        print(f"megabatch {label} frame={f}: K=4 vs K=1 streamed, {out[1].shape[0]} items "
              f"each, {rel:.3e} of peak (tol {CHAIN_TOL:g})")
        check(rel <= CHAIN_TOL, f"megabatch {label}: K=4 differs from K=1 by {rel:.3e}")
        n_items = STREAM_FRAMES * f
        for k in HOST_K:
            runs = []
            for _ in range(STREAM_RUNS):
                kern = _host_kernel_block(label, make, f, dev, k)
                fg = Flowgraph()
                snk = NullSink(kern.pipeline.out_dtype)
                fg.connect(NullSource(np.complex64), Head(np.complex64, n_items), kern, snk)
                rt = Runtime()
                t0 = time.perf_counter()
                rt.run(fg)
                runs.append(time.perf_counter() - t0)
                rt.shutdown()
                want = kern.pipeline.out_items(n_items)
                check(snk.n_received == want, f"streamed {label} K={k}: NullSink got "
                                              f"{snk.n_received} items, want {want}")
            rates[(label, f, k)] = n_items / statistics.median(runs) / 1e6
    st = arena().stats()
    print(f"arena: {st['hits']} takes from the pool, {st['misses']} allocations, "
          f"{st['pooled_bytes']} B pooled")
    check(st["hits"] > st["misses"], "arena: fewer takes from the pool than allocations")
    return rates


# ---------------------------------------------------------------------------
# phases 18-21: the message plane, the REST control port, the apps' main()
# and the circular buffer
# ---------------------------------------------------------------------------

MSG_COUNT = 50               # messages through MessageSource -> Copy -> Sink
REST_OFFSETS = (75e3, 90e3)  # the FM tuner before and after the REST retune
REST_LEVEL_TOL = 0.02        # relative, on each frame's mean discriminator level
REST_FRAMES_BEFORE = 8       # frames streamed before the retune is sent
REST_FRAMES_AFTER = 12       # frames streamed after it
MAIN_TIMEOUT_S = 300         # each app's main() as a subprocess
SPECTRUM_MAIN_SAMPLES = 1 << 26
FM_MAIN_WAV_FRAMES = 2       # audio frames in the WAV before "q" is sent
CIRC_FRAMES = 6              # frames (and a partial one) of the bit-equality runs


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rest(url: str, body=None) -> tuple:
    """``(status, parsed JSON body, round-trip seconds)`` of one request."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw, status = r.read(), r.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    return status, json.loads(raw), time.perf_counter() - t0


def ws_first_frame(port: int, timeout: float) -> tuple:
    """Connect to a websocket server on ``port`` (retrying until it listens),
    do the RFC 6455 handshake and return the first frame's
    ``(opcode, payload)``."""
    import base64
    import hashlib
    import os
    import socket
    import struct

    def exact(sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            check(bool(chunk), "websocket: server closed the connection")
            buf += chunk
        return buf

    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
            break
        except ConnectionRefusedError:
            check(time.monotonic() < deadline, f"websocket: nothing listens on {port}")
            time.sleep(0.05)
    with sock:
        key = base64.b64encode(os.urandom(16)).decode()
        sock.sendall((f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
                      f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            head += exact(sock, 1)
        accept = base64.b64encode(hashlib.sha1(
            key.encode() + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest()).decode()
        check(head.startswith(b"HTTP/1.1 101") and accept.encode() in head,
              f"websocket: bad handshake {head!r}")
        b0, b1 = exact(sock, 2)
        n = b1 & 0x7F
        if n == 126:
            n, = struct.unpack("!H", exact(sock, 2))
        elif n == 127:
            n, = struct.unpack("!Q", exact(sock, 8))
        payload = exact(sock, n)
        mask = os.urandom(4)
        close = struct.pack("!H", 1000)
        sock.sendall(struct.pack("!BB", 0x88, 0x82) + mask
                     + bytes(c ^ mask[i % 4] for i, c in enumerate(close)))
        return b0 & 0x0F, payload


def phase_message_plane(dev, taps, taps2) -> dict:
    """``MessageSource -> MessageCopy -> MessageSink``, then the handle's
    ``call``, ``post``, ``describe`` and ``metrics`` against a running
    streamed ``TpuKernel`` (the fused spectrum chain at 2^18) on the card;
    returns the handle calls' round-trip seconds."""
    from futuresdr_tpu_torch import Flowgraph, Pmt, Runtime
    from futuresdr_tpu_torch.blocks import (Head, MessageCopy, MessageSink, MessageSource,
                                            NullSink, NullSource)
    fg = Flowgraph()
    src, cp, snk = MessageSource(Pmt.usize(7), 0.001, count=MSG_COUNT), MessageCopy(), \
        MessageSink()
    fg.connect_message(src, "out", cp, "in")
    fg.connect_message(cp, "out", snk, "in")
    Runtime().run(fg)
    check(snk.received == [Pmt.usize(7)] * MSG_COUNT,
          f"message plane: {len(snk.received)} messages, want {MSG_COUNT}")

    frame = FRAMES[0]
    kern = _stream_kernel("fused", taps, frame, dev)
    fg = Flowgraph()
    nsnk = NullSink(np.float32)
    fg.connect(NullSource(np.complex64), Head(np.complex64, 1 << 50), kern, nsnk)
    rt = Runtime()
    running = rt.start(fg)
    h = running.handle
    deadline = time.monotonic() + 60
    while kern.frames_dispatched < 4:
        check(time.monotonic() < deadline, "message plane: the stream did not start")
        time.sleep(0.001)
    t0 = time.perf_counter()
    r = h.call_sync(kern, "ctrl", Pmt.map({"stage": 0, "taps": taps2}))
    call_s = time.perf_counter() - t0
    check(r == Pmt.ok(), f"message plane: ctrl call answered {r!r}")
    h.post_sync(kern, "ctrl", Pmt.map({"stage": 0, "taps": taps}))
    bad = h.call_sync(kern, "ctrl", Pmt.map({"stage": "nope", "taps": taps}))
    check(bad == Pmt.invalid_value(), f"message plane: a bad stage answered {bad!r}")
    desc = h.describe_sync()
    names = [b.type_name for b in desc.blocks]
    check(names == ["NullSource", "Head", "TpuKernel", "NullSink"],
          f"message plane: describe gave {names}")
    check(desc.blocks[2].message_inputs == ["ctrl"] and desc.blocks[2].blocking,
          f"message plane: TpuKernel described as {desc.blocks[2]}")
    t0 = time.perf_counter()
    m = h.metrics_sync()
    metrics_s = time.perf_counter() - t0
    km = m["TpuKernel_2"]
    check(km["messages_handled"] == 3 and km["work_calls"] > 0
          and km["items_in"]["in"] >= 4 * frame,
          f"message plane: TpuKernel metrics {km}")
    running.stop_sync()
    rt.shutdown()
    check(nsnk.n_received > 0, "message plane: nothing reached the sink")
    print(f"message plane: {MSG_COUNT} messages through MessageSource -> MessageCopy -> "
          f"MessageSink; handle on a streamed TpuKernel: ctrl call {call_s * 1e3:.3f} ms, "
          f"metrics {metrics_s * 1e3:.3f} ms, {kern.frames_dispatched} frames dispatched")
    return {"call_ms": call_s * 1e3, "metrics_ms": metrics_s * 1e3}


def phase_rest_retune(dev, wav_path) -> dict:
    """The FM app's card flowgraph with the Seify dummy radio
    (unthrottled, its tone at 0.1·fs), tuner at 75 kHz, retuned to 90 kHz by
    a POST of ``{"stage": "tuner", "phase_inc": θ}`` to the REST control
    port. Each audio frame's mean is the discriminator's DC level, which the
    gain gives for the tone's offset from the tuner: 25 kHz before, 10 kHz
    after. Returns the round trip and the frames from the POST to the first
    frame at the new level."""
    import wave

    from futuresdr_tpu_torch import Pmt, Runtime
    from futuresdr_tpu_torch.apps.fm_receiver import SAMPLE_RATE, build_flowgraph
    from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort
    from futuresdr_tpu_torch.tpu import TpuInstance
    before, after = REST_OFFSETS
    fg, tk, sink = build_flowgraph(None, input_rate=FM_RATE, offset=before,
                                   audio_path=str(wav_path), use_tpu=True,
                                   inst=TpuInstance(dev))
    rt = Runtime()
    cp = ControlPort(rt.handle, bind="127.0.0.1:0")
    cp.start()
    running = rt.start(fg)
    try:
        deadline = time.monotonic() + 120
        while tk.frames_dispatched < REST_FRAMES_BEFORE:
            check(time.monotonic() < deadline, "rest: the FM stream did not start")
            time.sleep(0.001)
        url = f"{cp.url}/api/fg/0/block/1/call/ctrl/"
        f0 = tk.frames_dispatched
        body = Pmt.map({"stage": "tuner", "phase_inc": -2 * np.pi * after / FM_RATE})
        status, reply, rtt = rest(url, body.to_json())
        check((status, reply) == (200, "Ok"), f"rest: retune answered {status} {reply!r}")
        status, bad, _ = rest(url, {"MapStrPmt": {"stage": {"String": "tuner"},
                                                  "phase_inc": {"String": "x"}}})
        check((status, bad) == (200, "InvalidValue"),
              f"rest: a malformed map answered {status} {bad!r}")
        status, bad, _ = rest(url, {"F64": 1.0})
        check(bad == "InvalidValue", f"rest: a non-map answered {bad!r}")
        while tk.frames_dispatched < f0 + REST_FRAMES_AFTER:
            check(time.monotonic() < deadline, "rest: the FM stream stopped")
            time.sleep(0.001)
        desc = rest(f"{cp.url}/api/fg/0/")[1]
        check([b["type_name"] for b in desc["blocks"]] ==
              ["SeifySource", "TpuKernel", "WavSink"], f"rest: fg described as {desc}")
    finally:
        running.stop_sync()
        cp.stop()
        rt.shutdown()
    with wave.open(str(wav_path), "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16) / 32767.0
    out_frame = tk.out_frame
    levels = pcm[:len(pcm) // out_frame * out_frame].reshape(-1, out_frame).mean(axis=1)
    gain = SAMPLE_RATE / (2 * np.pi * 75e3)
    want = [gain * 2 * np.pi * (0.1 * FM_RATE - off) / SAMPLE_RATE for off in REST_OFFSETS]
    near_new = [i for i, v in enumerate(levels)
                if i >= f0 and abs(v - want[1]) < abs(v - want[0])]
    check(bool(near_new), f"rest: no frame reached the new level {want[1]:.4f}: {levels}")
    f1 = near_new[0]
    old, new = levels[2:f0], levels[f1 + 2:]
    print(f"rest: tuner {before / 1e3:.0f} -> {after / 1e3:.0f} kHz by POST, round trip "
          f"{rtt * 1e3:.3f} ms; POST after frame {f0}, first frame at the new level "
          f"{f1} ({f1 - f0} frames later); DC level {np.median(old):.5f} before (want "
          f"{want[0]:.5f}), {np.median(new):.5f} after (want {want[1]:.5f}), "
          f"{len(levels)} frames")
    check(len(old) >= 4 and len(new) >= 4, f"rest: {len(old)} frames before the "
          f"retune and {len(new)} after it")
    for lv, w_ in ((old, want[0]), (new, want[1])):
        err = np.abs(lv - w_).max() / abs(w_)
        check(err <= REST_LEVEL_TOL, f"rest: DC level off by {err:.4f} of {w_:.5f} "
                                     f"(tol {REST_LEVEL_TOL})")
    return {"rtt_ms": rtt * 1e3, "frames": f1 - f0}


def phase_app_mains(wav_path) -> None:
    """Both apps' ``main()`` as a user starts them, each a subprocess under
    a timeout: the FM receiver on the card (its default) with ``--wav`` and ``25000`` then ``q``
    on its stdin (``q`` once the WAV holds audio), and the spectrum app with
    ``--samples`` and ``--ws-port`` read by a websocket client."""
    import os
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    cmd = [sys.executable, "-m", "futuresdr_tpu_torch.apps.fm_receiver",
           "--wav", str(wav_path)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        proc.stdin.write("25000\n")
        proc.stdin.flush()
        deadline = time.monotonic() + MAIN_TIMEOUT_S
        want_bytes = 44 + 2 * 12_576 * FM_MAIN_WAV_FRAMES
        while not (wav_path.exists() and wav_path.stat().st_size >= want_bytes):
            check(proc.poll() is None, f"fm main exited early ({proc.returncode})")
            check(time.monotonic() < deadline, "fm main: no audio in the WAV")
            time.sleep(0.05)
        proc.stdin.write("q\n")
        proc.stdin.flush()
        out, _ = proc.communicate(timeout=MAIN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    size = wav_path.stat().st_size
    print(f"fm main: {' '.join(cmd[1:])} exited {proc.returncode} after "
          f"{time.perf_counter() - t0:.1f} s, WAV {size} bytes")
    check(proc.returncode == 0 and size > 44, f"fm main: exit {proc.returncode}, WAV "
                                              f"{size} bytes; output:\n{out[-4000:]}")

    port = free_port()
    cmd = [sys.executable, "-m", "futuresdr_tpu_torch.apps.spectrum", "--samples",
           str(SPECTRUM_MAIN_SAMPLES), "--ws-port", str(port)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    try:
        opcode, payload = ws_first_frame(port, MAIN_TIMEOUT_S)
        out, _ = proc.communicate(timeout=MAIN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    spec = np.frombuffer(payload, np.float32)
    peak = int(np.argmax(spec)) if len(spec) else -1
    print(f"spectrum main: {' '.join(cmd[1:])} exited {proc.returncode} after "
          f"{time.perf_counter() - t0:.1f} s; first websocket frame: opcode {opcode}, "
          f"{len(spec)} floats, peak bin {peak} (want {round(0.1 * N_FFT)})")
    check(proc.returncode == 0, f"spectrum main: exit {proc.returncode}:\n{out[-4000:]}")
    check(opcode == 2 and len(spec) == N_FFT and peak == round(0.1 * N_FFT),
          "spectrum main: the first spectrum is not the dummy tone's")


def phase_circular(dev, taps) -> dict:
    """The streamed chains on the circular buffer (the default) against the
    pure-Python ring: ``VectorSource -> TpuKernel -> VectorSink`` gives the
    same items bit for bit, then ``NullSource -> Head -> TpuKernel ->
    NullSink`` at K = 1 and 4 on each buffer (median of STREAM_RUNS, the
    buffers in turns). Returns input Msps per (chain, frame, K, buffer)."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, VectorSink,
                                            VectorSource)
    from futuresdr_tpu_torch.runtime import default_buffer
    from futuresdr_tpu_torch.runtime.buffer.circular import CircularWriter
    from futuresdr_tpu_torch.runtime.buffer.ring import RingWriter
    check(default_buffer() is CircularWriter, "circular: not the default buffer")
    buffers = {"ring": RingWriter, "circular": CircularWriter}
    chains = [("spectrum fused", lambda: chain_stages("fused", taps), FRAMES[0]),
              ("fm kernel", lambda: fm_stages("kernel"), FM_FRAMES[0])]
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rates = {}

    def connect(fg, blocks, cls):
        for a, b in zip(blocks, blocks[1:]):
            fg.connect_stream(a, a.stream_outputs[0].name, b, b.stream_inputs[0].name,
                              buffer=cls)

    for label, make, f in chains:
        host = host_input(label, CIRC_FRAMES * f + f // 3 + 5, gen, dev).cpu().numpy()
        outs = {}
        for name, cls in buffers.items():
            kern = _host_kernel_block(label, make, f, dev, 1)
            vsnk = VectorSink(kern.pipeline.out_dtype)
            fg = Flowgraph()
            connect(fg, [VectorSource(host), kern, vsnk], cls)
            rt = Runtime()
            rt.run(fg)
            rt.shutdown()
            check(type(kern.input.reader._w if cls is CircularWriter
                       else kern.input.reader._writer) is cls
                  and type(kern.output.writer) is cls,
                  f"circular: {label} did not run on the {name} buffer")
            outs[name] = vsnk.items()
        equal = outs["ring"].shape == outs["circular"].shape and \
            np.array_equal(outs["ring"], outs["circular"])
        print(f"circular {label} frame={f}: {len(outs['ring'])} items on the ring, "
              f"{len(outs['circular'])} on the circular buffer, bit-equal {equal}")
        check(equal, f"circular: {label} differs between the ring and the circular buffer")
        n_items = STREAM_FRAMES * f
        for k in HOST_K:
            runs = {name: [] for name in buffers}
            for i in range(STREAM_RUNS * 2):
                name = ("ring", "circular", "circular", "ring")[i % 4]
                if len(runs[name]) == STREAM_RUNS:
                    name = "circular" if name == "ring" else "ring"
                kern = _host_kernel_block(label, make, f, dev, k)
                snk = NullSink(kern.pipeline.out_dtype)
                fg = Flowgraph()
                connect(fg, [NullSource(np.complex64), Head(np.complex64, n_items), kern,
                             snk], buffers[name])
                rt = Runtime()
                t0 = time.perf_counter()
                rt.run(fg)
                runs[name].append(time.perf_counter() - t0)
                rt.shutdown()
                want = kern.pipeline.out_items(n_items)
                check(snk.n_received == want, f"circular: {label} K={k} on the {name} "
                                              f"buffer: {snk.n_received} items, want {want}")
            for name, ts in runs.items():
                rates[(label, f, k, name)] = n_items / statistics.median(ts) / 1e6
    return rates


# ---------------------------------------------------------------------------
# phases 22-24: the device-frame plane and device-graph fusion, fused against
# per hop
# ---------------------------------------------------------------------------

DC_K = (1, 4)
DC_CHECK_FRAMES = 6          # frames of the fused-against-per-hop comparison
SPEC_KERNELS_22 = ("fir", "fir_fft")
DAG_KERNELS = ("fir", "poly_fir")


class _dc_mode:
    """Fused (the pass on) or per hop (``FSDR_NO_DEVCHAIN=1``) at K frames a
    dispatch, with stream buffers of at least 4 frames (as the reference's
    ``perf/devchain_ab.py`` sets them); restores both on exit."""

    def __init__(self, fused: bool, k: int, frame: int):
        self.fused, self.k, self.frame = fused, k, frame

    def __enter__(self):
        import os

        from futuresdr_tpu_torch.config import config
        self._old = (os.environ.pop("FSDR_NO_DEVCHAIN", None),
                     config().tpu_frames_per_dispatch, config().buffer_size)
        if not self.fused:
            os.environ["FSDR_NO_DEVCHAIN"] = "1"
        config().tpu_frames_per_dispatch = self.k
        config().buffer_size = max(config().buffer_size, 4 * self.frame * 8)
        return self

    def __exit__(self, *exc):
        import os

        from futuresdr_tpu_torch.config import config
        env, k, buf = self._old
        os.environ.pop("FSDR_NO_DEVCHAIN", None)
        if env is not None:
            os.environ["FSDR_NO_DEVCHAIN"] = env
        config().tpu_frames_per_dispatch = k
        config().buffer_size = buf


def _dispatches_a_frame(fg, members, fused: bool, frames: int) -> float:
    """Program dispatches a frame, read from the blocks' metrics: fused, the
    bridge's ``devchain_dispatches`` on a member (the fused kernel's
    replays); per hop, the sum of every member's own ``dispatches``."""
    if fused:
        m = fg.wrapped(members[0]).metrics()
        check(m.get("fused_devchain") is True, f"{members[0]!r}: the region did not fuse")
        check(m["devchain_frames"] == frames,
              f"fused region dispatched {m['devchain_frames']} frames, want {frames}")
        return m["devchain_dispatches"] / frames
    total = 0
    for b in members:
        m = fg.wrapped(b).metrics()
        check(not m.get("fused_devchain"), f"{b!r} fused under FSDR_NO_DEVCHAIN")
        total += m.get("dispatches", 0)
    return total / frames


def phase_devchain(dev, label: str, build, frame: int, n_members: int,
                   want_bytes: dict) -> dict:
    """One region fused against per hop. ``build(src, sink_cls)`` returns
    ``(fg, sinks, device members)``; ``want_bytes[(fused, direction)]`` the
    bytes a frame the link must carry where the phase fixes them. Returns
    ``{(fused, k): (Msps, dispatches a frame, h2d B a frame, d2h B a frame)}``
    and prints each line beside the card."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource, VectorSink, VectorSource
    from futuresdr_tpu_torch.ops import xfer
    from futuresdr_tpu_torch.runtime.devchain import find_device_chains
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    host = host_input(label, DC_CHECK_FRAMES * frame, gen, dev).cpu().numpy()
    for k in DC_K:
        outs = {}
        for fused in (False, True):
            with _dc_mode(fused, k, frame):
                fg, snks, members = build(VectorSource(host), VectorSink)
                check(len(find_device_chains(fg)) == int(fused),
                      f"{label} K={k}: the region {'did not fuse' if fused else 'fused'}")
                Runtime().run(fg)
                outs[fused] = [s.items() for s in snks]
        equal = []
        for j, (a, b) in enumerate(zip(outs[True], outs[False])):
            check(a.shape == b.shape and len(a) > 0,
                  f"{label} K={k} sink {j}: fused {a.shape}, per hop {b.shape}")
            eq = bool(np.array_equal(a, b))
            _, rel = rel_err(torch.from_numpy(a), torch.from_numpy(b))
            equal.append(eq)
            print(f"devchain {label} K={k} sink {j}: fused vs per hop over "
                  f"{DC_CHECK_FRAMES} frames, {len(a)} items, bit-equal {eq}, "
                  f"{rel:.3e} of peak")
            if k == 1:
                check(eq, f"{label} K=1 sink {j}: fused differs from per hop ({rel:.3e})")
            check(rel <= CHAIN_TOL, f"{label} K={k} sink {j}: fused differs from per hop "
                                    f"by {rel:.3e}")
    n_items = STREAM_FRAMES * frame
    res = {}
    for k in DC_K:
        runs = {False: [], True: []}
        stats = {}
        for fused in (False, True, True, False, False, True):
            with _dc_mode(fused, k, frame):
                fg, snks, members = build(
                    [NullSource(np.complex64), Head(np.complex64, n_items)], NullSink)
                xfer.reset_bytes()
                rt = Runtime()
                t0 = time.perf_counter()
                rt.run(fg)
                runs[fused].append(time.perf_counter() - t0)
                rt.shutdown()
                by = dict(xfer.bytes_total)
                disp = _dispatches_a_frame(fg, members, fused, STREAM_FRAMES)
                check(all(s.n_received > 0 for s in snks), f"{label}: a sink got nothing")
                stats[fused] = (disp, by["h2d"] / STREAM_FRAMES, by["d2h"] / STREAM_FRAMES)
        for fused in (False, True):
            disp, h2d, d2h = stats[fused]
            rate = n_items / statistics.median(runs[fused]) / 1e6
            res[(fused, k)] = (rate, disp, h2d, d2h)
            mode = "fused" if fused else "per hop"
            print(f"devchain {label} frame={frame} K={k} {mode}: {n_items} items in "
                  f"{', '.join(f'{t:.3f}' for t in runs[fused])} s, {disp:g} dispatches "
                  f"a frame, H2D {h2d:.0f} B and D2H {d2h:.0f} B a frame")
            want_disp = 1 / k if fused else (n_members if k == 1 else None)
            if want_disp is not None:
                check(abs(disp - want_disp) < 1e-9, f"{label} K={k} {mode}: {disp} "
                                                    f"dispatches a frame, want {want_disp}")
            for direction, got in (("h2d", h2d), ("d2h", d2h)):
                want = want_bytes.get((fused, direction))
                if want is not None:
                    check(got == want, f"{label} K={k} {mode}: {direction} {got:.0f} B a "
                                       f"frame, want {want}")
    return res


def _src_into(fg, src, first, port="in"):
    """Connect a source (a block, or a ``[NullSource, Head]`` pair) into
    ``first``."""
    from futuresdr_tpu_torch.blocks import VectorSource
    if isinstance(src, VectorSource):
        fg.connect_stream(src, "out", first, port)
    else:
        fg.connect(*src)
        fg.connect_stream(src[-1], "out", first, port)


def phase_devchain_linear(dev, taps) -> dict:
    """Phase 22: the spectrum chain on the frame plane (3 stage blocks) and
    as two TpuKernels over a stream edge."""
    from futuresdr_tpu_torch import Flowgraph
    from futuresdr_tpu_torch.ops.stages import (fft_stage, fir_fft_stage, fir_stage,
                                                mag2_stage)
    from futuresdr_tpu_torch.tpu import TpuD2H, TpuH2D, TpuInstance, TpuKernel, TpuStage
    frame = FRAMES[0]
    inst = TpuInstance(dev)

    def frame_plane(src, sink_cls):
        fg = Flowgraph()
        h2d = TpuH2D(np.complex64, frame_size=frame, inst=inst, max_inflight=IN_FLIGHT,
                     wire=LINK)
        sts = [TpuStage([s], np.complex64, inst=inst) for s in
               (fir_stage(taps, impl="pallas"), fft_stage(N_FFT), mag2_stage())]
        d2h, snk = TpuD2H(np.float32, inst=inst, wire=LINK), sink_cls(np.float32)
        _src_into(fg, src, h2d)
        fg.connect(h2d, *sts, d2h, snk)
        return fg, [snk], [h2d, *sts, d2h]

    def kernels(src, sink_cls):
        fg = Flowgraph()
        k1 = TpuKernel([fir_fft_stage(taps, N_FFT)], np.complex64, frame_size=frame,
                       inst=inst, frames_in_flight=IN_FLIGHT, wire=LINK)
        k2 = TpuKernel([mag2_stage()], np.complex64, frame_size=frame, inst=inst,
                       frames_in_flight=IN_FLIGHT, wire=LINK)
        snk = sink_cls(np.float32)
        _src_into(fg, src, k1)
        fg.connect(k1, k2, snk)
        return fg, [snk], [k1, k2]

    f_in, f_out = frame * 8, frame * 4
    return {
        "spectrum frame plane": phase_devchain(
            dev, "spectrum frame plane", frame_plane, frame, 3,
            {(True, "h2d"): f_in, (True, "d2h"): f_out,
             (False, "h2d"): f_in, (False, "d2h"): f_out}),
        "spectrum kernels": phase_devchain(
            dev, "spectrum kernels", kernels, frame, 2,
            {(True, "h2d"): f_in, (True, "d2h"): f_out,
             (False, "h2d"): f_in + frame * 8, (False, "d2h"): f_out + frame * 8})}


def phase_devchain_fanout(dev) -> dict:
    """Phase 23: the FM front end's producer broadcast to the audio
    resampler and a |x|^2 level branch, TpuKernels over stream edges."""
    from futuresdr_tpu_torch import Flowgraph
    from futuresdr_tpu_torch.ops.stages import mag2_stage, resample_stage
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    frame = FM_FRAMES[0]
    demod = frame // 4
    inst = TpuInstance(dev)

    def build(src, sink_cls):
        fg = Flowgraph()
        prod = TpuKernel(fm_stages("kernel")[:3], np.complex64, frame_size=frame,
                         inst=inst, frames_in_flight=IN_FLIGHT, wire=LINK)
        audio = TpuKernel([resample_stage(24, 125, impl="pallas")], np.float32,
                          frame_size=demod, inst=inst, frames_in_flight=IN_FLIGHT, wire=LINK)
        level = TpuKernel([mag2_stage()], np.float32, frame_size=demod, inst=inst,
                          frames_in_flight=IN_FLIGHT, wire=LINK)
        s_audio, s_level = sink_cls(np.float32), sink_cls(np.float32)
        _src_into(fg, src, prod)
        fg.connect_stream(prod, "out", audio, "in")
        fg.connect_stream(prod, "out", level, "in")
        fg.connect(audio, s_audio)
        fg.connect(level, s_level)
        return fg, [s_audio, s_level], [prod, audio, level]

    out_b = demod * 24 // 125 * 4 + demod * 4
    return {"fm fan-out": phase_devchain(
        dev, "fm fan-out", build, frame, 3,
        {(True, "h2d"): frame * 8, (False, "h2d"): frame * 8 + 2 * demod * 4,
         (True, "d2h"): out_b, (False, "d2h"): out_b + demod * 4})}


def phase_devchain_dag(dev) -> dict:
    """Phase 24: the diamond on the frame plane and the stream-plane nested
    fan-out ``prod -> {a -> {c, d}, b}``."""
    from futuresdr_tpu_torch import Flowgraph
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import add_merge_stage, fir_stage, mag2_stage
    from futuresdr_tpu_torch.tpu import (TpuD2H, TpuH2D, TpuInstance, TpuKernel,
                                         TpuMergeStage, TpuStage)
    frame = FM_FRAMES[0]
    inst = TpuInstance(dev)
    lp1, lp2 = firdes.lowpass(0.1, 128), firdes.lowpass(0.05, 128)

    def diamond(src, sink_cls):
        fg = Flowgraph()
        h2d = TpuH2D(np.complex64, frame_size=frame, inst=inst, max_inflight=IN_FLIGHT,
                     wire=LINK)
        b1 = TpuStage([fir_stage(lp1, decim=4, impl="pallas", name="b1")], np.complex64,
                      inst=inst)
        b2 = TpuStage([fir_stage(lp2, decim=4, impl="pallas", name="b2")], np.complex64,
                      inst=inst)
        mg = TpuMergeStage(add_merge_stage(2), [mag2_stage()], inst=inst)
        d2h, snk = TpuD2H(np.float32, inst=inst, wire=LINK), sink_cls(np.float32)
        _src_into(fg, src, h2d)
        fg.connect_inplace(h2d, "out", b1, "in")
        fg.connect_inplace(h2d, "out", b2, "in")
        fg.connect_inplace(b1, "out", mg, "in0")
        fg.connect_inplace(b2, "out", mg, "in1")
        fg.connect(mg, d2h, snk)
        return fg, [snk], [mg, h2d, b1, b2, d2h]

    t1 = firdes.lowpass(0.25, N_TAPS).astype(np.float32)
    t2 = firdes.lowpass(0.2, N_TAPS).astype(np.float32)

    def nested(src, sink_cls):
        def tk(stages):
            return TpuKernel(stages, np.complex64, frame_size=frame, inst=inst,
                             frames_in_flight=IN_FLIGHT, wire=LINK)

        fg = Flowgraph()
        prod, a = tk([fir_stage(t1, impl="pallas", name="p")]), \
            tk([fir_stage(t2, impl="pallas", name="a")])
        b, d = tk([mag2_stage()]), tk([mag2_stage()])
        c = tk([fir_stage(t2, decim=4, impl="pallas", name="c")])
        snks = [sink_cls(np.complex64), sink_cls(np.float32), sink_cls(np.float32)]
        _src_into(fg, src, prod)
        for x, y in ((prod, a), (prod, b), (a, c), (a, d)):
            fg.connect_stream(x, "out", y, "in")
        for x, snk in zip((c, d, b), snks):
            fg.connect(x, snk)
        return fg, snks, [prod, a, b, c, d]

    sinks_nested = frame // 4 * 8 + frame * 4 + frame * 4
    return {
        "diamond": phase_devchain(
            dev, "diamond", diamond, frame, 3,
            {(True, "h2d"): frame * 8, (True, "d2h"): frame // 4 * 4,
             (False, "h2d"): frame * 8, (False, "d2h"): frame // 4 * 4}),
        "nested fan-out": phase_devchain(
            dev, "nested fan-out", nested, frame, 5,
            {(True, "h2d"): frame * 8, (True, "d2h"): sinks_nested,
             (False, "h2d"): 5 * frame * 8, (False, "d2h"): sinks_nested + 2 * frame * 8})}


# ---------------------------------------------------------------------------
# phase 25: the wires
# ---------------------------------------------------------------------------

WIRE_NAMES = ("f32", "bf16", "sc16", "sc8")
WIRE_FRAMES = 8              # frames of each streamed check of the wires
# Streamed output against the resident float32 chain, by SNR: the reference's
# measured one-crossing floors (tests/test_wire.py:56: bf16 35, sc16 80, sc8
# 38 dB) less 12 dB, for the two crossings (in and out) and the square in
# |x|^2 of the spectrum chain; f32 is held bit for bit.
WIRE_SNR = {"bf16": 23.0, "sc16": 68.0, "sc8": 26.0}
WIRE_SEG = 6                 # frames of each segment of the wire-switch run
ADAPT_FRAME = 1 << 14        # the adaptive wire run's frame
ADAPT_TONE, ADAPT_BURST = 64, 96   # its frames of tone, then of bursts
FAULT_RATE = 0.2             # injected transient H2D faults a transfer


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _to_dev(parts, dev):
    import torch
    return tuple(torch.from_numpy(np.array(p)).to(dev) for p in parts)


def _codec_inputs(dev):
    """The codec checks' frames, on the card: 2^18 and 512,000 complex64, a
    float32 2^18 frame, non-finite samples, an all-zero frame."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 250)
    bad = randc(1 << 16, gen, dev)
    bad[5] = complex(float("nan"), 1.0)
    bad[77] = complex(float("inf"), 0.0)
    bad[900] = complex(0.0, float("-inf"))
    return {"c64 2^18": randc(1 << 18, gen, dev) * 3,
            "c64 512000": randc(512_000, gen, dev),
            "f32 2^18": torch.randn(1 << 18, generator=gen, device=dev),
            "non-finite": bad,
            "zero": torch.zeros(4096, dtype=torch.complex64, device=dev)}


def phase_wire_codecs(dev) -> None:
    """(a) Each wire's device decode and encode against its host twin on the
    card, bit for bit (bf16: every finite value; a NaN's bits are the
    device's), then K = 4 frames a dispatch through a captured wired program
    (the identity chain), each frame with its own peak: the program's output
    parts equal the host's re-encode of each frame, per part and packed."""
    import torch

    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.ops import xfer
    from futuresdr_tpu_torch.ops.wire import get_wire
    inputs = _codec_inputs(dev)
    for name in WIRE_NAMES:
        w = get_wire(name)
        for label, x in inputs.items():
            xh = x.cpu().numpy()
            parts = w.encode_host(xh)
            got = w.decode_torch(_to_dev(parts, dev), xh.dtype).cpu().numpy()
            want = w.decode_host(parts, xh.dtype)
            check(np.array_equal(_bits(got), _bits(want)),
                  f"wire {name} {label}: the device decode differs from the host's")
            enc = [p.cpu().numpy() for p in w.encode_torch(x)]
            flat = xh.view(np.float32) if np.iscomplexobj(xh) else xh
            for e, h in zip(enc, parts):
                h = np.asarray(h)
                if name == "bf16":
                    keep = np.isfinite(flat).reshape(h.shape)
                    ok = np.array_equal(e[keep], h[keep])
                else:
                    ok = np.array_equal(_bits(e), _bits(h))
                check(ok, f"wire {name} {label}: the device encode differs from the host's")
        n, k = 1 << 16, 4
        gen = torch.Generator(device=dev).manual_seed(SEED + 251)
        xs = [(randc(n, gen, dev) * 10.0 ** (-2 * i)).cpu().numpy() for i in range(k)]
        enc = [w.encode_host(x) for x in xs]
        stacked = [np.stack([np.asarray(e[j]) for e in enc]) for j in range(len(enc[0]))]
        pipe = T.Pipeline([T.apply_stage(lambda v: v.clone())], np.complex64)
        lay = xfer.PackedLayout.probe(w, n, np.complex64, k=k)
        fn, carry = pipe.compile(n, dev, k=k, wire=w)
        _, y = fn(carry, _to_dev(stacked, dev))
        outs = [[p.cpu().numpy() for p in y]]
        if lay is not None:
            pfn, pcarry = pipe.compile(n, dev, k=k, wire=w, packed=lay)
            buf = lay.pack(stacked, np.empty(lay.nbytes, np.uint8))
            _, py = pfn(pcarry, _to_dev((buf,), dev))
            outs.append([p.cpu().numpy() for p in py])
        for out in outs:
            for i, e in enumerate(enc):
                again = w.encode_host(w.decode_host(e, np.complex64))
                for j, h in enumerate(again):
                    check(np.array_equal(_bits(out[j][i]), _bits(h)),
                          f"wire {name} K={k}: frame {i}'s part {j} differs from its "
                          f"host re-encode")
        if len(enc[0]) > 1:
            scales = outs[0][1]
            check(len(set(scales.tolist())) == k, f"wire {name}: one scale for K frames "
                                                  f"({scales})")
        print(f"wire {name}: device decode and encode equal the host twin on "
              f"{', '.join(inputs)}; K={k} captured program (per part"
              f"{' and packed' if lay is not None else ''}) equals each frame's host "
              f"re-encode")


def _wire_kernel(stages, frame, dev, k, wire):
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    return TpuKernel(stages, np.complex64, frame_size=frame, inst=TpuInstance(dev),
                     frames_in_flight=IN_FLIGHT, frames_per_dispatch=k, wire=wire)


def _run_vector(kern, host):
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    fg = Flowgraph()
    snk = VectorSink(kern.pipeline.out_dtype)
    fg.connect(VectorSource(host), kern, snk)
    rt = Runtime()
    rt.run(fg)
    rt.shutdown()
    return snk.items()


def _wire_bytes(kern, k: int) -> tuple:
    """H2D and D2H bytes a frame of ``kern``'s wire by construction: the
    packed layout's (or the parts') bytes over K, and the output's parts."""
    w = kern.wire
    if kern._packed is not None:
        up = kern._packed.nbytes / k
    else:
        up = sum(int(np.prod(sh)) * dt.itemsize for sh, dt in kern._part_specs)
    down = sum(np.asarray(p).nbytes for p in
               w.encode_host(np.zeros(kern.out_frame, kern.pipeline.out_dtype)))
    return up, down


def phase_wires_streamed(dev, taps) -> dict:
    """(b) ``VectorSource -> TpuKernel(wire=w) -> VectorSink`` per wire at K
    = 1 and 4 against the resident float32 chain (the plain compiled
    program, the one the streamed path replayed before the wires) on the
    same frames: f32 bit for bit, the others by SNR (WIRE_SNR); (c) the link
    bytes a frame (``xfer.bytes_total``) against the wire's by construction,
    and one H2D start a dispatch group where the parts are packed. Returns
    ``{(chain, k, wire): (snr dB, h2d B, d2h B)}``."""
    import torch

    from futuresdr_tpu_torch.ops import xfer
    from futuresdr_tpu_torch.ops.stages import Pipeline
    gen = torch.Generator(device=dev).manual_seed(SEED + 252)
    chains = [("spectrum fused", lambda: chain_stages("fused", taps), FRAMES[0]),
              ("fm kernel", lambda: fm_stages("kernel"), FM_FRAMES[0])]
    found = {}
    for label, make, f in chains:
        host_t = host_input(label, WIRE_FRAMES * f, gen, dev)
        host = host_t.cpu().numpy()
        frames = list(host_t.reshape(WIRE_FRAMES, f))
        for k in HOST_K:
            fn, carry = Pipeline(make(), np.complex64).compile(f, dev, k=k)
            ref = run_compiled(fn, carry, frames, k).cpu()
            del fn, carry
            for name in WIRE_NAMES:
                kern = _wire_kernel(make(), f, dev, k, name)
                xfer.reset_bytes()
                got = torch.from_numpy(_run_vector(kern, host))
                h2d = xfer.bytes_total["h2d"] / WIRE_FRAMES
                d2h = xfer.bytes_total["d2h"] / WIRE_FRAMES
                starts = xfer.starts_total["h2d"]
                check(got.shape == ref.shape, f"wires {label} K={k} {name}: "
                      f"{tuple(got.shape)} items, want {tuple(ref.shape)}")
                if name == "f32":
                    check(torch.equal(got, ref), f"wires {label} K={k}: the f32 wire "
                          f"differs from the resident float32 chain")
                    snr = float("inf")
                else:
                    snr = snr_db(got, ref)
                    check(snr >= WIRE_SNR[name], f"wires {label} K={k} {name}: output "
                          f"SNR {snr:.2f} dB against float32, limit {WIRE_SNR[name]}")
                up, down = _wire_bytes(kern, k)
                check(h2d == up and d2h == down, f"wires {label} K={k} {name}: "
                      f"{h2d:g} B up, {d2h:g} B down a frame, want {up:g} and {down:g}")
                groups = WIRE_FRAMES // k
                want_starts = groups * (1 if kern._packed is not None
                                        else len(kern._part_specs))
                check(starts == want_starts, f"wires {label} K={k} {name}: {starts} H2D "
                      f"starts, want {want_starts}")
                found[(label, k, name)] = (snr, h2d, d2h)
                print(f"wires {label} frame={f} K={k} {name}: "
                      f"{'bit-equal to' if name == 'f32' else f'SNR {snr:.2f} dB against'}"
                      f" the resident float32 chain; H2D {h2d:.0f} B, D2H {d2h:.0f} B a "
                      f"frame, {starts} H2D starts for {groups} groups")
    # at 2^18: sc16 1,048,640 B up (the payload, and the scale in a 64-byte
    # slot) and 524,292 down, against f32's 2,097,152 and 1,048,576
    f = FRAMES[0]
    spec = {n: found[("spectrum fused", 1, n)][1:] for n in ("f32", "sc16")}
    check(spec["sc16"] == (4 * f + 64, 2 * f + 4) and spec["f32"] == (8 * f, 4 * f),
          f"wires: spectrum K=1 bytes a frame {spec}")
    return found


def phase_wire_frames(dev, taps) -> None:
    """(d) ``TpuH2D(wire="sc16") -> TpuStage[fir_fft] -> TpuStage[|x|^2] ->
    TpuD2H(wire="sc16")`` fused and per hop, bit for bit; the same region
    with an f32 ``TpuD2H`` does not fuse."""
    import os

    import torch

    from futuresdr_tpu_torch import Flowgraph
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops.stages import fir_fft_stage, mag2_stage
    from futuresdr_tpu_torch.runtime.devchain import find_device_chains
    from futuresdr_tpu_torch.tpu import TpuD2H, TpuH2D, TpuInstance, TpuStage
    f = FRAMES[0]
    inst = TpuInstance(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 253)
    host = randc(WIRE_FRAMES * f, gen, dev).cpu().numpy()

    def build(d2h_wire):
        fg = Flowgraph()
        h2d = TpuH2D(np.complex64, frame_size=f, inst=inst, max_inflight=IN_FLIGHT,
                     wire="sc16")
        sts = [TpuStage([s], np.complex64, inst=inst)
               for s in (fir_fft_stage(taps, N_FFT), mag2_stage())]
        d2h, snk = TpuD2H(np.float32, inst=inst, wire=d2h_wire), VectorSink(np.float32)
        fg.connect(VectorSource(host), h2d, *sts, d2h, snk)
        return fg, snk

    from futuresdr_tpu_torch import Runtime
    out = {}
    for fused in (False, True):
        old = os.environ.pop("FSDR_NO_DEVCHAIN", None)
        if not fused:
            os.environ["FSDR_NO_DEVCHAIN"] = "1"
        try:
            fg, snk = build("sc16")
            check(len(find_device_chains(fg)) == int(fused),
                  f"wire frames: {'no' if fused else 'a'} fused region")
            Runtime().run(fg)
            out[fused] = snk.items()
            if fused:
                fg2, _ = build("f32")
                check(find_device_chains(fg2) == [], "wire frames: a region whose end "
                                                     "wires differ fused")
        finally:
            os.environ.pop("FSDR_NO_DEVCHAIN", None)
            if old is not None:
                os.environ["FSDR_NO_DEVCHAIN"] = old
    check(out[True].shape == out[False].shape == (WIRE_FRAMES * f,) and
          np.array_equal(out[True], out[False]),
          "wire frames: the fused sc16 region differs from per hop")
    print(f"wire frames: TpuH2D(sc16) -> 2 stages -> TpuD2H(sc16) at 2^18, fused "
          f"bit-equal to per hop over {WIRE_FRAMES} frames; an f32 D2H does not fuse")


def _gated_source(items, gates):
    """A source that emits ``items`` up to each gate's item index, then waits
    for its event (``gates``: ``[(index, threading.Event)]``)."""
    import asyncio

    from futuresdr_tpu_torch import Kernel

    class Gated(Kernel):
        def __init__(self):
            super().__init__()
            self.pos = 0
            self.output = self.add_stream_output("out", items.dtype)

        async def work(self, io, mio, meta):
            end = len(items)
            for at, ev in gates:
                if not ev.is_set():
                    end = at
                    break
            if self.pos >= end:
                await asyncio.sleep(0.001)
                io.call_again = True
                return
            out = self.output.slice()
            n = min(len(out), end - self.pos)
            out[:n] = items[self.pos:self.pos + n]
            self.output.produce(n)
            self.pos += n
            if self.pos == len(items):
                io.finished = True
            elif n:
                io.call_again = True

    return Gated()


def phase_wire_switch(dev, taps) -> dict:
    """(e) The spectrum chain streamed at 2^18 on f32, switched to sc8 by
    ``apply_wire_retune`` once WIRE_SEG frames went out (the source held),
    then back to f32: every frame comes out; each segment equals the
    chained wired programs on the card (the same carry through f32, sc8, f32
    programs) at CHAIN_TOL, and the sc8 segment the resident float32 chain
    at sc8's SNR limit; going back to f32 takes its first program, with no
    new capture. Then ``tpu_adaptive_wire``: a tone stepping down to a quiet
    floor with full-scale bursts widens an sc8 kernel to sc16. Returns the
    switches' frames."""
    import threading

    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.ops.stages import Pipeline
    from futuresdr_tpu_torch.ops.wire import get_wire
    f = FRAMES[0]
    n = 3 * WIRE_SEG
    gen = torch.Generator(device=dev).manual_seed(SEED + 254)
    host = randc(n * f, gen, dev).cpu().numpy()
    gates = [(WIRE_SEG * f, threading.Event()), (2 * WIRE_SEG * f, threading.Event())]
    kern = _wire_kernel(chain_stages("fused", taps), f, dev, 1, "f32")
    fg = Flowgraph()
    snk = VectorSink(np.float32)
    fg.connect(_gated_source(host, gates), kern, snk)
    rt = Runtime()
    running = rt.start(fg)
    first = None
    try:
        for (at, ev), nxt in zip(gates, ("sc8", "f32")):
            deadline = time.monotonic() + 120
            while kern.frames_dispatched < at // f:
                check(time.monotonic() < deadline, "wire switch: the stream stalled")
                time.sleep(0.001)
            first = first or kern._fn
            kern.apply_wire_retune(nxt)
            ev.set()
        running.wait_sync()
    finally:
        rt.shutdown()
    got = torch.from_numpy(snk.items())
    check(got.shape == (n * f,), f"wire switch: {tuple(got.shape)} items, want {n * f}")
    hist = kern.wire_history
    check(hist == [(0, "f32"), (WIRE_SEG, "sc8"), (2 * WIRE_SEG, "f32")],
          f"wire switch: history {hist}")
    check(kern._fn is first and len(kern._programs) == 2 and first.captures == 1,
          f"wire switch: back to f32 took {len(kern._programs)} programs, "
          f"{first.captures} captures of the first")
    pipe = Pipeline(chain_stages("fused", taps), np.complex64)
    progs, carry = {}, None
    outs = []
    for i in range(n):
        name = "sc8" if WIRE_SEG <= i < 2 * WIRE_SEG else "f32"
        w = get_wire(name)
        if name not in progs:
            share = next(iter(progs.values())).carry if progs else None
            progs[name], c0 = pipe.compile(f, dev, wire=w, carry=share)
            carry = c0 if carry is None else carry
        carry, y = progs[name](carry, _to_dev(w.encode_host(host[i * f:(i + 1) * f]), dev))
        outs.append(torch.from_numpy(w.decode_host(tuple(p.cpu().numpy() for p in y),
                                                   np.float32)))
    chained = torch.cat(outs)
    fn, c = pipe.compile(f, dev)
    plain = run_compiled(fn, c, list(torch.from_numpy(host).to(dev).reshape(n, f)), 1).cpu()
    seg = WIRE_SEG * f
    for s in range(3):
        _, rel = rel_err(got[s * seg:(s + 1) * seg], chained[s * seg:(s + 1) * seg])
        check(rel <= CHAIN_TOL, f"wire switch: segment {s} differs from the chained "
                                f"programs by {rel:.3e}")
    snr = snr_db(got[seg:2 * seg], plain[seg:2 * seg])
    check(snr >= WIRE_SNR["sc8"], f"wire switch: the sc8 segment reads {snr:.2f} dB")
    bit = bool(torch.equal(got, chained))
    print(f"wire switch: f32 -> sc8 at frame {WIRE_SEG} -> f32 at frame {2 * WIRE_SEG}, "
          f"{n} frames out ({'bit-equal to' if bit else f'within {CHAIN_TOL:g} of'} the "
          f"chained wired programs), the sc8 segment {snr:.2f} dB against float32; back "
          f"to f32 on its first program ({first.captures} capture)")

    saved = config().tpu_adaptive_wire
    config().tpu_adaptive_wire = True
    try:
        m = ADAPT_FRAME
        t = np.arange(ADAPT_TONE * m)
        tone = np.exp(2j * np.pi * 0.05 * t).astype(np.complex64)
        burst = np.full(ADAPT_BURST * m, 1e-3, np.complex64)
        burst[::m // 16] = 1.0
        from futuresdr_tpu_torch.ops.stages import mag2_stage
        adapt = _wire_kernel([mag2_stage()], m, dev, 1, "sc8")
        check(adapt.extra_metrics()["adaptive_wire"] == 1, "adaptive wire: not armed")
        got = _run_vector(adapt, np.concatenate([tone, burst]))
    finally:
        config().tpu_adaptive_wire = saved
    names = [w for _, w in adapt.wire_history]
    check(len(got) == (ADAPT_TONE + ADAPT_BURST) * m, "adaptive wire: items lost")
    check(names[:2] == ["sc8", "sc16"] and adapt.wire_history[1][0] >= ADAPT_TONE,
          f"adaptive wire: history {adapt.wire_history}")
    print(f"adaptive wire: sc8 widened to sc16 at frame {adapt.wire_history[1][0]} (the "
          f"step to bursts at frame {ADAPT_TONE}); history {adapt.wire_history}")
    return {"switch_frames": [a for a, _ in hist[1:]], "adaptive": adapt.wire_history}


def phase_wire_ingest(dev) -> None:
    """(f) A registered read-only buffer (page-locked by ``register``)
    streamed through ``TpuKernel(wire="f32")`` counts every frame zero-copy
    and equals the copying run bit for bit; ``unregister`` unlocks it."""
    import torch

    from futuresdr_tpu_torch import Mocker
    from futuresdr_tpu_torch.ops import ingest
    from futuresdr_tpu_torch.ops.stages import fir_fft_stage, mag2_stage
    f = FRAMES[0]
    taps = np.hanning(N_TAPS).astype(np.float32) / np.float32(np.hanning(N_TAPS).sum())
    gen = torch.Generator(device=dev).manual_seed(SEED + 255)
    data = randc(WIRE_FRAMES * f, gen, dev).cpu().numpy()

    def drive():
        kern = _wire_kernel([fir_fft_stage(taps, N_FFT), mag2_stage()], f, dev, 1, "f32")
        m = Mocker(kern)
        m.input("in", data)
        m.init_output("out", len(data))
        m.init()
        m.run()
        return m.output("out").copy(), kern.extra_metrics()

    want, em0 = drive()
    h = ingest.register(data, name="capture")
    check(h.page_locked, "ingest: register did not page-lock the buffer on the card")
    got, em = drive()
    check(em0["ingest_zero_copy_frac"] == 0.0 and em["ingest_zero_copy_frac"] == 1.0,
          f"ingest: zero-copy share {em['ingest_zero_copy_frac']}")
    check(not h.pinned, "ingest: frames still hold the buffer after the run")
    check(len(got) == len(data) and np.array_equal(got, want),
          "ingest: the zero-copy run differs from the copying run")
    ingest.unregister(h)
    check(h.refcount == 0 and not h.page_locked, "ingest: unregister left the pages locked")
    print(f"ingest: {WIRE_FRAMES} frames of a registered page-locked buffer staged "
          f"zero-copy, bit-equal to the copying run")


def phase_wire_faults(dev, taps) -> dict:
    """(g) Transient H2D faults at FAULT_RATE a transfer (``runtime/faults``,
    seeded) on the sc16 wire: the output equals the unfaulted run bit for
    bit, with the retries counted; every transfer faulting exhausts the
    retry budget and fails the flowgraph with ``TransferError``."""
    import torch

    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.ops import xfer
    from futuresdr_tpu_torch.runtime import faults
    from futuresdr_tpu_torch.runtime.runtime import FlowgraphError
    f = FRAMES[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 256)
    host = randc(WIRE_FRAMES * f, gen, dev).cpu().numpy()
    want = _run_vector(_wire_kernel(chain_stages("fused", taps), f, dev, 1, "sc16"), host)
    saved = config().xfer_backoff
    config().xfer_backoff = 0.0005
    try:
        faults.arm("h2d", rate=FAULT_RATE, seed=SEED)
        xfer.reset_bytes()
        got = _run_vector(_wire_kernel(chain_stages("fused", taps), f, dev, 1, "sc16"), host)
        retries = xfer.retries_total["h2d"]
        faults.reset()
        check(retries > 0, "faults: no H2D fault fired")
        check(np.array_equal(got, want), "faults: the faulted run differs")
        faults.arm("h2d", rate=1.0, seed=SEED)
        causes = []
        try:
            _run_vector(_wire_kernel(chain_stages("fused", taps), f, dev, 1, "sc16"), host)
        except FlowgraphError as e:
            while e is not None:
                causes.append(type(e).__name__)
                e = e.__cause__
        check("TransferError" in causes, f"faults: an exhausted budget raised {causes}")
    finally:
        faults.reset()
        config().xfer_backoff = saved
    print(f"faults: h2d at {FAULT_RATE} a transfer, {retries} retries, output bit-equal "
          f"to the unfaulted run; an exhausted budget fails with TransferError")
    return {"retries": retries}


def phase_wire_rates(dev, taps) -> dict:
    """(h) ``NullSource -> Head -> TpuKernel(wire) -> NullSink`` on the
    spectrum fused chain at 2^18 per wire at K = 1 and 4, median of
    STREAM_RUNS (the wires in turns), with the wire's measured codec SNR.
    Returns ``{(wire, k): Msps}``."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource
    f = FRAMES[0]
    n_items = STREAM_FRAMES * f
    runs = {(w, k): [] for w in WIRE_NAMES for k in HOST_K}
    for _ in range(STREAM_RUNS):
        for (name, k), times in runs.items():
            kern = _wire_kernel(chain_stages("fused", taps), f, dev, k, name)
            fg = Flowgraph()
            snk = NullSink(np.float32)
            fg.connect(NullSource(np.complex64), Head(np.complex64, n_items), kern, snk)
            rt = Runtime()
            t0 = time.perf_counter()
            rt.run(fg)
            times.append(time.perf_counter() - t0)
            rt.shutdown()
            check(snk.n_received == n_items, f"wire rates {name} K={k}: "
                                             f"{snk.n_received} items, want {n_items}")
    return {key: n_items / statistics.median(t) / 1e6 for key, t in runs.items()}


def phase_wires(dev, taps) -> dict:
    """Phase 25, the wires: (a) codecs, (b)-(c) streamed against resident with
    the link bytes, (d) the frame plane and fusion, (e) switches and the
    adaptive wire, (f) zero-copy ingest, (g) transfer faults, (h) rates."""
    phase_wire_codecs(dev)
    streamed = phase_wires_streamed(dev, taps)
    phase_wire_frames(dev, taps)
    switch = phase_wire_switch(dev, taps)
    phase_wire_ingest(dev)
    flt = phase_wire_faults(dev, taps)
    rates = phase_wire_rates(dev, taps)
    return {"streamed": streamed, "switch": switch, "faults": flt, "rates": rates}


# ---------------------------------------------------------------------------
# phase 26: recovery on the streamed path
# ---------------------------------------------------------------------------

REC_CHAINS = ("spectrum fused", "spectrum pallas", "fm kernel")
REC_K = (1, 4)
REC_CADENCE = (1, 8)
REC_GROUPS = 2 * max(REC_CADENCE) + 1   # dispatch groups a run, and a partial frame
REC_FAULTS = ("dispatch", "h2d", "carry")
REC_RATE_FRAMES = 64        # frames of each rate run (NullSource -> Head)
REC_DISK_FRAMES = 10        # frames across the two processes of (d)
REC_DISK_CUT = 6            # of which the first process streams these


def _rec_stages(chain, taps):
    """``(stages, frame, kernels)`` of a chain of phase 26."""
    if chain.startswith("spectrum "):
        route = chain.split()[1]
        return chain_stages(route, taps), FRAMES[0], (ROUTE_KERNEL[route],)
    return fm_stages("kernel"), FM_FRAMES[0], FM_KERNELS


def _rec_input(chain, n, dev):
    """The chain's input (FM IQ, or complex noise), made on the card."""
    import torch
    if chain.startswith("fm "):
        return fm_iq(n, dev).cpu().numpy()
    gen = torch.Generator(device=dev).manual_seed(SEED + 260)
    return randc(n, gen, dev).cpu().numpy()


def _seed_firing_at(site: str, rate: float, n: int) -> int:
    """A seed whose injector at ``site`` (``runtime/faults.py``: its own
    ``random.Random(f"{seed}:{site}")``) fires first at draw ``n``."""
    import random
    for seed in range(100_000):
        rng = random.Random(f"{seed}:{site}")
        first = next(i for i in range(1, 10_000) if rng.random() < rate)
        if first == n:
            return seed
    raise SmokeError(f"no seed fires {site} first at draw {n}")


def _rec_kernel(chain, taps, dev, k, ck, restart=True):
    from futuresdr_tpu_torch import BlockPolicy
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    stages, frame, _ = _rec_stages(chain, taps)
    kern = TpuKernel(stages, np.complex64, frame_size=frame, inst=TpuInstance(dev),
                     frames_in_flight=IN_FLIGHT, frames_per_dispatch=k, wire=LINK,
                     checkpoint_every=ck)
    if restart:
        kern.policy = BlockPolicy(on_error="restart", max_restarts=4, backoff=0.0)
    return kern


def _wait_for(cond, what: str, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"recovery: {what} never came")
        time.sleep(0.001)


def _rec_run(chain, taps, dev, host, k, ck, fault):
    """``host`` through ``gated source -> TpuKernel(restart, cadence ck) ->
    VectorSink`` with ``fault`` armed mid-stream (non-transient): dispatch
    and h2d fire at the dispatch group ck + 2; carry corrupts the commit of
    group 2·ck - 1 (the source holds after ck and 2·ck groups), then a
    dispatch fault hits group 2·ck, so that the restore must reject the
    corrupted newest checkpoint and take the one before. Returns (output,
    kernel, restarts, seconds from the fault's recovery to the first
    replayed output)."""
    import threading

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink
    from futuresdr_tpu_torch.runtime import faults
    kern = _rec_kernel(chain, taps, dev, k, ck)
    group = k * kern.frame_size
    gates = [(ck * group, threading.Event()), (2 * ck * group, threading.Event())] \
        if fault == "carry" else []
    fg = Flowgraph()
    snk = VectorSink(kern.pipeline.out_dtype)
    fg.connect(_gated_source(host, gates), kern, snk)
    name = fg.wrapped(kern).instance_name
    t = {}
    recover = kern.recover

    async def timed_recover(err):
        t["fault"] = time.perf_counter()
        return await recover(err)

    kern.recover = timed_recover
    drain = kern._drain_one

    def timed_drain():
        d = kern._inflight[0]
        drain()
        if "fault" in t and "first" not in t and not d.drop:
            t["first"] = time.perf_counter()

    kern._drain_one = timed_drain
    plan = faults.reset()
    if fault in ("dispatch", "h2d"):
        site = f"dispatch:{name}" if fault == "dispatch" else "h2d"
        plan.arm(site, rate=0.3, seed=_seed_firing_at(site, 0.3, ck + 3), max_faults=1,
                 transient=False)
    rt = Runtime()
    try:
        running = rt.start(fg)
        if fault == "carry":
            # arm once the first segment's checkpoint committed: the next
            # commit (group 2·ck - 1) is the one corrupted
            _wait_for(lambda: kern._ckpts and kern._ckpts[-1][0] == ck - 1,
                      "the first segment's checkpoint")
            carry = plan.arm("carry", rate=1.0, max_faults=1)
            gates[0][1].set()
            _wait_for(lambda: kern._ckpts[-1][0] == 2 * ck - 1,
                      "the second segment's checkpoint")
            check(carry.fired == 1,
                  f"recovery {chain}: the carry fault did not corrupt the newest commit")
            plan.arm(f"dispatch:{name}", rate=1.0, max_faults=1, transient=False)
            gates[1][1].set()
        running.wait_sync(timeout=300)
    finally:
        faults.reset()
        rt.shutdown()
    return snk.items(), kern, fg.wrapped(kern).restarts, \
        t.get("first", float("nan")) - t.get("fault", float("nan"))


def phase_recovery_restart(dev, taps) -> dict:
    """(a) Each chain at K = 1 and 4 under ``restart`` at cadence 1 and 8,
    each fault of REC_FAULTS mid-stream: the output equals the fault-free
    run bit for bit, with a restart, frames replayed and the program
    captured once; the carry case rejected its corrupted candidate. Returns
    the time from the recovery to the first replayed output per case."""
    import torch
    to_first = {}
    for chain in REC_CHAINS:
        for k in REC_K:
            _, frame, _ = _rec_stages(chain, taps)
            host = _rec_input(chain, REC_GROUPS * k * frame + frame // 3, dev)
            ref_kern = _rec_kernel(chain, taps, dev, k, None, restart=False)
            want = _run_vector(ref_kern, host)
            check(ref_kern.extra_metrics()["checkpoint_every"] == 0,
                  "recovery: a fail-fast kernel took checkpoints")
            check(bool(np.isfinite(want).all()) and len(want) > 0,
                  f"recovery {chain}: the fault-free output is empty or not finite")
            for ck in REC_CADENCE:
                for fault in REC_FAULTS:
                    got, kern, restarts, dt = _rec_run(chain, taps, dev, host, k, ck, fault)
                    label = f"recovery {chain} K={k} cadence {ck} {fault}"
                    check(restarts >= 1, f"{label}: no restart")
                    check(kern.frames_replayed > 0, f"{label}: nothing replayed")
                    check(kern._fn.captures == 1 and len(kern._programs) == 1,
                          f"{label}: the recovery captured again "
                          f"({kern._fn.captures} captures)")
                    if fault == "carry":
                        check(kern.checkpoints_rejected >= 1,
                              f"{label}: the corrupted checkpoint was not rejected")
                    check(len(got) == len(want) and np.array_equal(got, want),
                          f"{label}: the recovered output differs from the fault-free run")
                    to_first[(chain, k, ck, fault)] = dt
                    print(f"{label}: bit-equal to the fault-free run, {restarts} restart(s), "
                          f"{kern.frames_replayed} frames replayed, "
                          f"{kern.checkpoints_rejected} checkpoint(s) rejected, 1 capture; "
                          f"recovery to first replayed output {dt * 1e3:.3f} ms")
            del host, want
            torch.cuda.empty_cache()
    return to_first


def phase_recovery_devchain(dev, taps) -> None:
    """(b) Phase 22's frame-plane region (three TpuStages) and phase 23's
    fan-out, each with a ``restart`` member, fused, a bare dispatch fault
    mid-stream: bit-equal to the fault-free fused run."""
    from futuresdr_tpu_torch import BlockPolicy, Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops.stages import (fft_stage, fir_stage, mag2_stage,
                                                resample_stage)
    from futuresdr_tpu_torch.runtime import faults
    from futuresdr_tpu_torch.tpu import TpuD2H, TpuH2D, TpuInstance, TpuKernel, TpuStage
    inst = TpuInstance(dev)
    policy = BlockPolicy(on_error="restart", max_restarts=4, backoff=0.0)

    def linear(host):
        fg = Flowgraph()
        h2d = TpuH2D(np.complex64, frame_size=FRAMES[0], inst=inst, max_inflight=IN_FLIGHT,
                     wire=LINK)
        sts = [TpuStage([s], np.complex64, inst=inst) for s in
               (fir_stage(taps, impl="pallas"), fft_stage(N_FFT), mag2_stage())]
        sts[1].policy = policy
        snk = VectorSink(np.float32)
        fg.connect(VectorSource(host), h2d, *sts, TpuD2H(np.float32, inst=inst, wire=LINK),
                   snk)
        return fg, sts[1], [snk]

    def fanout(host):
        fg = Flowgraph()
        frame = FM_FRAMES[0]
        prod = TpuKernel(fm_stages("kernel")[:3], np.complex64, frame_size=frame,
                         inst=inst, frames_in_flight=IN_FLIGHT, wire=LINK)
        prod.policy = policy
        audio = TpuKernel([resample_stage(24, 125, impl="pallas")], np.float32,
                          frame_size=frame // 4, inst=inst, frames_in_flight=IN_FLIGHT,
                          wire=LINK)
        level = TpuKernel([mag2_stage()], np.float32, frame_size=frame // 4, inst=inst,
                          frames_in_flight=IN_FLIGHT, wire=LINK)
        sinks = [VectorSink(np.float32), VectorSink(np.float32)]
        fg.connect(VectorSource(host), prod)
        fg.connect_stream(prod, "out", audio, "in")
        fg.connect_stream(prod, "out", level, "in")
        fg.connect(audio, sinks[0])
        fg.connect(level, sinks[1])
        return fg, prod, sinks

    for label, build, chain in (("spectrum frame plane", linear, "spectrum pallas"),
                                ("fm fan-out", fanout, "fm kernel")):
        _, frame, _ = _rec_stages(chain, taps)
        host = _rec_input(chain, 12 * frame + frame // 3, dev)
        outs = {}
        for fault in (False, True):
            fg, member, sinks = build(host)
            plan = faults.reset()
            if fault:
                plan.arm("dispatch", rate=0.3, seed=_seed_firing_at("dispatch", 0.3, 6),
                         max_faults=1, transient=False)
            rt = Runtime()
            try:
                rt.run(fg, timeout=300)
            finally:
                faults.reset()
                rt.shutdown()
            wk = fg.wrapped(member)
            check(wk.metrics().get("fused_devchain") is True,
                  f"recovery {label}: the region with a restart member did not fuse")
            check(wk.restarts == (1 if fault else 0),
                  f"recovery {label}: {wk.restarts} restarts")
            outs[fault] = [s.items() for s in sinks]
        for got, want in zip(outs[True], outs[False]):
            check(len(got) == len(want) and np.array_equal(got, want),
                  f"recovery {label}: the fused recovery differs from the fault-free run")
        print(f"recovery {label}: fused with a restart member, a dispatch fault at group 5 "
              f"recovered bit-equal to the fault-free run on every sink")


def phase_recovery_forfeit(dev, taps) -> None:
    """(c) Cadence 0 under ``restart``: the recovery declines, the fresh init
    forfeits the in-flight window (counted) and the run completes."""
    chain, k = "spectrum fused", 1
    _, frame, _ = _rec_stages(chain, taps)
    host = _rec_input(chain, REC_GROUPS * frame, dev)
    want = _run_vector(_rec_kernel(chain, taps, dev, k, None, restart=False), host)
    got, kern, restarts, _ = _rec_run(chain, taps, dev, host, k, 0, "dispatch")
    check(restarts == 1 and kern.frames_replayed == 0 and kern.frames_forfeited > 0,
          f"checkpoint off: {restarts} restarts, {kern.frames_replayed} replayed, "
          f"{kern.frames_forfeited} forfeited")
    check(kern.extra_metrics()["fsdr_frames_forfeited_total"] == kern.frames_forfeited,
          "checkpoint off: the forfeited frames are not in the metrics")
    check(0 < len(got) < len(want), f"checkpoint off: {len(got)} items of {len(want)}")
    print(f"recovery checkpoint off: the restart forfeited {kern.frames_forfeited} frames "
          f"(counted), {len(got)} of {len(want)} items out, the run completed")


def _disk_kernel(taps, dev):
    kern = _rec_kernel("spectrum fused", taps, dev, 1, 1, restart=False)
    kern.meta.instance_name = "rx_chain"
    return kern


def _disk_input(dev):
    f = FRAMES[0]
    return _rec_input("spectrum fused", REC_DISK_FRAMES * f, dev), f


def _mock(kern, parts):
    """``parts`` (arrays, or None for a recover()) through a Mocker."""
    import asyncio

    from futuresdr_tpu_torch import Mocker
    m = Mocker(kern)
    m.init_output("out", REC_DISK_FRAMES * kern.frame_size)
    m.init()
    for p in parts:
        if p is None:
            check(asyncio.run(kern.recover(RuntimeError("process restart"))),
                  "checkpoint_dir: recover() declined")
        else:
            m.input("in", p)
            m.run()
    return m.output("out").copy()


def ckpt_process(part: int, ckpt_dir: str) -> int:
    """One process of (d): part 1 streams the first REC_DISK_CUT frames with
    ``checkpoint_dir`` set and waits for the write; part 2, a new kernel with
    nothing of its own, restores from the file and streams the rest. Each
    saves its output beside the checkpoint."""
    import os

    import torch

    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.utils import snapshot
    dev = torch.device(DEVICE)
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    config().checkpoint_dir = ckpt_dir
    host, f = _disk_input(dev)
    kern = _disk_kernel(taps, dev)
    cut = REC_DISK_CUT * f
    parts = [host[:cut]] if part == 1 else [None, host[cut:]]
    out = _mock(kern, parts)
    snapshot.persist_executor().submit(lambda: None).result()
    np.save(os.path.join(ckpt_dir, f"out{part}.npy"), out)
    return 0


def phase_recovery_disk(dev, taps) -> None:
    """(d) ``checkpoint_dir`` across two processes: the second restores from
    the first's file and the two outputs make the uninterrupted run, bit for
    bit; a corrupted file is rejected (the restore falls back to the fresh
    carry)."""
    import asyncio
    import os
    import tempfile

    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.ops.stages import _leaves
    host, f = _disk_input(dev)
    want = _mock(_disk_kernel(taps, dev), [host])
    with tempfile.TemporaryDirectory(dir=str(_build_dir().parent)) as d:
        for part in (1, 2):
            res = subprocess.run([sys.executable, __file__, "--ckpt-part", str(part),
                                  "--ckpt-dir", d], capture_output=True, text=True,
                                 timeout=300)
            check(res.returncode == 0, f"checkpoint_dir: process {part} failed: "
                                       f"{res.stderr[-2000:]}")
        got = np.concatenate([np.load(os.path.join(d, "out1.npy")),
                              np.load(os.path.join(d, "out2.npy"))])
        check(len(got) == len(want) and np.array_equal(got, want),
              "checkpoint_dir: the two processes' output differs from the uninterrupted run")
        old = config().checkpoint_dir
        config().checkpoint_dir = d
        try:
            kern = _disk_kernel(taps, dev)
            path = kern._ckpt_file()
            raw = bytearray(open(path, "rb").read())
            raw[len(raw) // 2] ^= 0xFF
            open(path, "wb").write(bytes(raw))
            asyncio.run(kern.init(kern.mio, kern.meta))
            check(kern._load_disk_ckpt() is None, "checkpoint_dir: a corrupted file loaded")
            check(asyncio.run(kern.recover(RuntimeError("restart"))),
                  "checkpoint_dir: recover() declined after a corrupted file")
            fresh = kern.pipeline.init_carry(dev)
            check(all(bool((a == b).all()) for a, b in
                       zip(_leaves(kern._carry), _leaves(fresh))),
                  "checkpoint_dir: the corrupted file's carry was restored")
        finally:
            config().checkpoint_dir = old
    print(f"recovery checkpoint_dir: a second process restored the first's checkpoint "
          f"after {REC_DISK_CUT} frames, the outputs together bit-equal to one run of "
          f"{REC_DISK_FRAMES} frames; a corrupted file was rejected")


def _build_dir():
    from futuresdr_tpu_torch.ops import _build
    return _build.BUILD_DIR


def phase_recovery_isolate(dev, taps) -> None:
    """(e) Two independent branches, the FM one ``isolate`` with a work fault:
    it retires, the run raises with the isolate decision, and the spectrum
    branch's output equals its solo run bit for bit."""
    from futuresdr_tpu_torch import BlockPolicy, Flowgraph, FlowgraphError, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.runtime import faults
    n_frames = 8
    spec = _rec_input("spectrum fused", n_frames * FRAMES[0], dev)
    fm = _rec_input("fm kernel", n_frames * FM_FRAMES[0], dev)
    solo = _run_vector(_rec_kernel("spectrum fused", taps, dev, 1, None, restart=False),
                       spec)
    fg = Flowgraph()
    snk_a = VectorSink(np.float32)
    fg.connect(VectorSource(spec), _rec_kernel("spectrum fused", taps, dev, 1, None,
                                               restart=False), snk_a)
    bad = _rec_kernel("fm kernel", taps, dev, 1, None, restart=False)
    bad.policy = BlockPolicy(on_error="isolate")
    fg.connect(VectorSource(fm), bad, VectorSink(np.float32))
    name = fg.wrapped(bad).instance_name
    faults.reset().arm(f"work:{name}", rate=0.3,
                       seed=_seed_firing_at(f"work:{name}", 0.3, 5), max_faults=1)
    rt = Runtime()
    err = None
    try:
        rt.run(fg, timeout=300)
    except FlowgraphError as e:
        err = e
    finally:
        faults.reset()
        rt.shutdown()
    check(err is not None and err.blocks == [name] and
          [d["action"] for d in err.policy_decisions] == ["isolate"],
          f"isolate: {err!r} {getattr(err, 'policy_decisions', None)}")
    got = snk_a.items()
    check(len(got) == len(solo) and np.array_equal(got, solo),
          "isolate: the independent branch differs from its solo run")
    print(f"recovery isolate: the FM branch retired on a work fault (decision "
          f"{err.policy_decisions[0]['action']}), the spectrum branch bit-equal to its "
          f"solo run ({len(got)} items)")


def phase_recovery_rates(dev, taps) -> dict:
    """(f) The spectrum fused chain streamed at 2^18, NullSource -> Head ->
    TpuKernel -> NullSink, at K = 1 and 4 with cadence 0 (the default path),
    1 and 8 (restart policy), no fault, the cadences in turns: median input
    Msamples/s and the arena's peak pinned bytes."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource
    from futuresdr_tpu_torch.ops.arena import arena
    frame = FRAMES[0]
    n_items = REC_RATE_FRAMES * frame
    runs, peaks = {}, {}
    for _ in range(STREAM_RUNS):
        for k in REC_K:
            for ck in (0,) + REC_CADENCE:
                kern = _rec_kernel("spectrum fused", taps, dev, k, ck or None,
                                   restart=bool(ck))
                fg = Flowgraph()
                snk = NullSink(np.float32)
                fg.connect(NullSource(np.complex64), Head(np.complex64, n_items), kern, snk)
                ar = arena()
                ar.peak_pinned_bytes = ar.pinned_bytes
                rt = Runtime()
                t0 = time.perf_counter()
                rt.run(fg)
                dt = time.perf_counter() - t0
                rt.shutdown()
                check(snk.n_received == n_items, f"recovery rate K={k} cadence {ck}: "
                                                 f"{snk.n_received} items")
                check(kern.extra_metrics()["checkpoint_every"] == ck,
                      f"recovery rate: cadence {kern.extra_metrics()['checkpoint_every']}")
                runs.setdefault((k, ck), []).append(dt)
                peaks[(k, ck)] = max(peaks.get((k, ck), 0), ar.peak_pinned_bytes)
    return {key: (n_items / statistics.median(v) / 1e6, peaks[key])
            for key, v in runs.items()}


def phase_recovery(dev, taps) -> dict:
    """Phase 26, recovery: (a) restart replays, (b) fused regions, (c)
    checkpoints off, (d) checkpoint_dir across processes, (e) isolate, (f)
    rates and the arena's peak."""
    to_first = phase_recovery_restart(dev, taps)
    phase_recovery_devchain(dev, taps)
    phase_recovery_forfeit(dev, taps)
    phase_recovery_disk(dev, taps)
    phase_recovery_isolate(dev, taps)
    return {"to_first": to_first, "rates": phase_recovery_rates(dev, taps)}


# ---------------------------------------------------------------------------
# phase 27: precision and tuning
# ---------------------------------------------------------------------------

AB_BUDGET = 40.0             # interior_snr_budget_db of the auto rows
AB_K = (16, 64)              # utils/measure.run_marginal's two run lengths
AB_SNR_FRAMES = 4            # fresh chained frames of each row's SNR against f32
AB_MODES = ("f32", "auto", "bf16", "int8")
PREC_STREAM_FRAMES = 24      # frames of the streamed precision runs (phase 27e)
APP_PREC_SAMPLES = 1 << 22   # the spectrum app's samples with --bf16 / --autotune
# PERF.md §6's Bound column (µs), three significant digits, at each timed call
PERF_BOUND_US = {("fir", 1 << 18): 1.25, ("fir", 1 << 20): 5.01,
                 ("fir_fft", 1 << 18): 1.26, ("fir_fft", 1 << 20): 5.01,
                 ("rotator", 512_000): 2.45, ("rotator", 4_096_000): 19.6,
                 ("poly_fir", 512_000): 1.80, ("poly_fir", 4_096_000): 14.4,
                 ("poly_fir/channel", 512_000): 1.53, ("poly_fir/resampler", 512_000): 0.275,
                 ("poly_fir/resampler", 4_096_000): 2.20,
                 ("quad_demod", 512_000): 0.459, ("quad_demod", 4_096_000): 3.67,
                 ("pfb", 1 << 18): 1.25, ("pfb", 1 << 21): 10.0,
                 ("pfb/N=2048", 1 << 18): 1.34, ("poly_fir/decimator", 1 << 18): 0.666}
PREC_KERNELS = ("fir", "fir_fft", "poly_fir", "pfb")


def ab_chains():
    """The A/B matrix of the JAX package's ``perf/precision_ab.py``, and the
    spectrum chain on the ``fir`` kernel: ``label -> (pipeline factory, has
    an int8 rung)``."""
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import (Pipeline, channelizer_stage, fft_stage,
                                                fir_fft_stage, fir_stage, mag2_stage)
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    dtaps = firdes.lowpass(0.04, 128).astype(np.float32)
    c64 = np.complex64
    return {
        "spectrum": (lambda: Pipeline([fir_stage(taps), fft_stage(N_FFT), mag2_stage()],
                                      c64), True),
        "spectrum pallas": (lambda: Pipeline([fir_stage(taps, impl="pallas"),
                                              fft_stage(N_FFT), mag2_stage()], c64), True),
        "spectrum fused": (lambda: Pipeline([fir_fft_stage(taps, N_FFT), mag2_stage()],
                                            c64, optimize=False), False),
        "pfb-64 matmul": (lambda: Pipeline([channelizer_stage(64, impl="matmul")], c64),
                          False),
        "pfb-64 pallas": (lambda: Pipeline([channelizer_stage(64, impl="pallas")], c64),
                          False),
        "decimator poly": (lambda: Pipeline([fir_stage(dtaps, decim=16, impl="poly")], c64),
                           True),
        "decimator pallas": (lambda: Pipeline([fir_stage(dtaps, decim=16, impl="pallas")],
                                              c64), True),
    }


def _run_frames(pipe, frames, dev):
    """``pipe`` eagerly over ``frames`` (host arrays), the carry chained;
    the outputs concatenated on the host."""
    import torch
    c, outs, fn = pipe.init_carry(dev), [], pipe.fn()
    with torch.no_grad():
        for f in frames:
            c, y = fn(c, torch.from_numpy(f).to(dev))
            outs.append(y.cpu())
    return torch.cat(outs)


def phase_precision_ab(dev) -> dict:
    """27 (a): every row of the A/B matrix at 2^18 in f32, auto (40 dB), bf16
    and int8 (where the row has the rung), resident, through
    ``utils/measure.run_marginal`` (K = 16 and 64 chained frames, one CUDA
    graph each): Msamples/s and card µs a frame; each plan's lowered count,
    minimum SNR and end-to-end SNR, and the lowered program against f32 on
    fresh frames, which must clear ``budget - 10·log10(n_lowered)``; ``off``
    returns the pipeline itself, and its output bits are the f32 run's."""
    import torch

    from futuresdr_tpu_torch.ops import precision as P
    from futuresdr_tpu_torch.utils.measure import run_marginal_retry
    frame = FRAMES[0]
    rng = np.random.default_rng(SEED + 27)
    x = torch.from_numpy(((rng.standard_normal(frame) + 1j * rng.standard_normal(frame))
                          / np.sqrt(2)).astype(np.complex64)).to(dev)
    fresh = [((rng.standard_normal(frame) + 1j * rng.standard_normal(frame))
              / np.sqrt(2)).astype(np.complex64) for _ in range(AB_SNR_FRAMES)]
    out = {}
    for label, (make, has_int8) in ab_chains().items():
        base = make()
        off, _plan = P.plan_interior_precision(base, mode="off")
        check(off is base, f"{label}: interior_precision off built a new pipeline")
        ref = _run_frames(base, fresh, dev)
        again = _run_frames(off, fresh, dev)
        check(torch.equal(torch.view_as_real(ref) if ref.is_complex() else ref,
                          torch.view_as_real(again) if again.is_complex() else again),
              f"{label}: the off program's bits differ from the f32 run's")
        for mode in AB_MODES:
            if mode == "int8" and not has_int8:
                continue
            if mode == "f32":
                pipe, plan = base, None
            else:
                pipe, plan = P.plan_interior_precision(base, mode=mode, budget_db=AB_BUDGET,
                                                       device=dev)
            rate = run_marginal_retry(pipe.fn(), pipe.init_carry(dev), x, k_pair=AB_K)
            got = _run_frames(pipe, fresh, dev)
            check(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                      else got).all()), f"{label} {mode}: non-finite output")
            snr = float("inf") if pipe is base else snr_db(got, ref)
            row = {"msps": rate / 1e6, "us": frame / rate * 1e6, "snr": snr}
            if plan is not None:
                row.update(lowered=plan.lowered, min_snr=plan.min_snr_db,
                           e2e=plan.e2e_snr_db, declined_e2e=plan.declined_e2e,
                           plan=[(e.stage, e.accum, e.edge) for e in plan.edges])
                if mode == "auto" and plan.lowered:
                    floor = AB_BUDGET - 10 * np.log10(plan.lowered)
                    check(plan.e2e_snr_db >= floor and snr >= floor,
                          f"{label} auto: end-to-end {plan.e2e_snr_db:.2f} dB, fresh "
                          f"{snr:.2f} dB under the floor {floor:.2f} dB")
            out[(label, mode)] = row
            print(f"precision {label} {mode}: {row['msps']:.1f} Msamples/s, card "
                  f"{row['us']:.2f} us a frame, against f32 {snr:.2f} dB"
                  + ("" if plan is None else
                     f", lowered {plan.lowered}, min {plan.min_snr_db} dB, e2e "
                     f"{plan.e2e_snr_db} dB, plan {row['plan']}"))
    return out


def phase_precision_int8(dev) -> None:
    """27 (b): the int8 rungs on the card equal their CPU computation bit
    for bit (each quantized value one correctly rounded division, an exact
    integer accumulator, the same dequantizing products): the spectrum
    chain's banded int8 FIR (``torch._int_mm``) and the decimator's int8
    shifted matvec, two chained 2^18 frames."""
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import Pipeline, fir_stage
    rng = np.random.default_rng(SEED + 28)
    frames = [((rng.standard_normal(FRAMES[0]) + 1j * rng.standard_normal(FRAMES[0]))
               / np.sqrt(2)).astype(np.complex64) for _ in range(2)]
    for label, stage in (
            ("fir banded int8", lambda: fir_stage(firdes.lowpass(0.2, N_TAPS),
                                                  precision="int8")),
            ("decimator int8", lambda: fir_stage(firdes.lowpass(0.04, 128), decim=16,
                                                 impl="pallas", precision="int8"))):
        pipe = Pipeline([stage()], np.complex64)
        card = _run_frames(pipe, frames, dev).numpy()
        cpu = _run_frames(pipe, frames, "cpu").numpy()
        same = np.array_equal(card.view(np.uint32), cpu.view(np.uint32))
        print(f"precision int8 {label}: card against CPU bit-equal {same} "
              f"(max |diff| {float(np.max(np.abs(card - cpu))):.3e})")
        check(same, f"{label}: the card's int8 rung differs from the CPU's")


def phase_plan_sweep(dev) -> dict:
    """27 (c): the kernel-plan sweep over all six kernels at the main paths'
    shapes (``tpu/kernel_tune.SHAPES``): every candidate held against its
    plain version at phase 7's limits (a failure or a skip fails the
    phase), the winners recorded in a cache under a temporary
    ``autotune_cache_dir``, installed by a fresh ``TpuKernel``'s init, and
    each kernel's next launch taking the recorded plan."""
    import tempfile

    import torch

    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel, kernel_tune
    at = sys.modules["futuresdr_tpu_torch.tpu.autotune"]
    inst = TpuInstance(dev)
    stages = ab_chains()["spectrum pallas"][0]().stages
    old_dir = config().autotune_cache_dir
    tmp = tempfile.mkdtemp(dir=str(_build_dir()))
    config().autotune_cache_dir = tmp
    try:
        t0 = time.perf_counter()
        winners = at.autotune_pallas_blocks(stages, np.complex64, inst=inst, reps=REPS,
                                            force=True)
        res = at.autotune_pallas_blocks.last_sweep
        took = time.perf_counter() - t0
        check(res["failures"] == [], f"plan sweep failures: {res['failures']}")
        n_cand = 0
        for kernel, by_shape in res["matrix"].items():
            for shape, times in by_shape.items():
                cands = ck.plan_candidates(kernel, *shape)
                n_cand += len(cands)
                check(set(times) == set(cands),
                      f"plan sweep {kernel} {shape}: {len(cands) - len(times)} "
                      f"candidate(s) not timed")
                rule, best = cands[0], res["winners"][kernel][shape]
                errs = res["errors"][kernel][shape]
                print(f"plan sweep {kernel} [{res['labels'][(kernel, shape)]}]: "
                      f"{len(cands)} layouts, max error {max(errs.values()):.2e} (tol "
                      f"{kernel_tune.TOL[kernel]:g}); rule {tuple(rule)[:6]} "
                      f"{times[rule] * 1e6:.2f} us, winner {tuple(best)[:6]} "
                      f"{times[best] * 1e6:.2f} us, fastest "
                      f"{min(times.values()) * 1e6:.2f} us")
        print(f"plan sweep: {n_cand} layouts of {len(res['matrix'])} kernels in "
              f"{took:.1f} s, device key {res['device']!r}")
        check(set(res["winners"]) == set(ck.PLAN_KERNELS), "the sweep missed a kernel")
        # a cache hit skips the sweep; a fresh kernel's init installs the plans
        calls = {"n": 0}
        real = kernel_tune.sweep_plans

        def counting(*a, **k):
            calls["n"] += 1
            return real(*a, **k)

        kernel_tune.sweep_plans = counting
        try:
            hit = at.autotune_pallas_blocks(stages, np.complex64, inst=inst)
        finally:
            kernel_tune.sweep_plans = real
        check(calls["n"] == 0 and hit == winners, "the plan cache's hit ran a sweep")
        ck.set_tuned_plans(None)
        TpuKernel(stages, np.complex64, frame_size=FRAMES[0], inst=inst)
        tuned = ck.tuned_plans()
        check(tuned == ck.normalize_plans(winners), "a fresh TpuKernel did not install "
                                                    "the recorded plans")
        gen = torch.Generator(device=dev).manual_seed(SEED + 29)
        for kernel, label, spec in kernel_tune.SHAPES:
            shape, args, call, _plain = kernel_tune._workload(kernel, spec, dev, 1, gen)
            call(None, *args[0])
            want = tuned[kernel][shape]
            check(ck.last_plans.get(kernel) == want, f"{kernel} [{label}]: the next launch "
                                                 f"took {ck.last_plans.get(kernel)}, the "
                                                 f"recorded plan is {want}")
        torch.cuda.synchronize()
        print(f"plan sweep: a fresh TpuKernel installed the recorded plans; each "
              f"kernel's next launch took its recorded plan")
        return {"winners": res["winners"], "matrix": res["matrix"]}
    finally:
        ck.set_tuned_plans(None)
        config().autotune_cache_dir = old_dir
        at._streamed_cache.clear()
        at._disk_memo.clear()


def phase_cache_runtime(dev, taps) -> None:
    """27 (d): the cache reaches the runtime: a ``TpuKernel`` seeds its
    credits and its adaptive wire's start from the cached pick, and phase
    22's linear region (two ``TpuKernel``s) launches fused with its cached
    K."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.ops.stages import fir_fft_stage, mag2_stage
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    at = sys.modules["futuresdr_tpu_torch.tpu.autotune"]
    inst = TpuInstance(dev)
    plat = at.platform_of(inst)
    frame = FRAMES[0]
    c = config()
    old = (c.tpu_adaptive_wire, c.tpu_frames_per_dispatch, c.tpu_inflight)
    try:
        c.tpu_adaptive_wire, c.tpu_frames_per_dispatch, c.tpu_inflight = True, 0, 0
        stages = [fir_fft_stage(taps, N_FFT), mag2_stage()]
        at.record_streamed_pick(stages, np.complex64, plat, 1, inflight=3)
        at.record_wire_start(stages, np.complex64, plat, "sc8")
        tk = TpuKernel(stages, np.complex64, frame_size=frame, inst=inst, wire="sc16")
        check(tk.depth == 3 and tk._credits.credits == 3 and tk._credits.adaptive,
              f"credit seed {tk.depth}, want the cached 3")
        check(tk.wire.name == "sc8", f"adaptive wire starts at {tk.wire.name}, want sc8")
        c.tpu_adaptive_wire = False
        k = 4
        region = [fir_fft_stage(taps, N_FFT), mag2_stage()]
        at.record_streamed_pick(region, np.complex64, plat, k)
        fg = Flowgraph()
        k1 = TpuKernel(region[:1], np.complex64, frame_size=frame, inst=inst,
                       frames_in_flight=IN_FLIGHT, wire=LINK)
        k2 = TpuKernel(region[1:], np.complex64, frame_size=frame, inst=inst,
                       frames_in_flight=IN_FLIGHT, wire=LINK)
        fg.connect(NullSource(np.complex64), Head(np.complex64, 3 * k * frame), k1, k2,
                   NullSink(np.float32))
        Runtime().run(fg)
        m = fg.wrapped(k1).metrics()
        check(m.get("fused_devchain") is True and m["frames_per_dispatch"] == k and
              m["devchain_frames"] == 3 * k and m["devchain_dispatches"] == 3,
              f"the fused region did not launch with the cached K={k}: {m}")
        print(f"cache: a TpuKernel seeded 3 credits and started its adaptive wire at sc8 "
              f"from the cached pick; the fused spectrum region launched at the cached "
              f"K={k} ({m['devchain_dispatches']} dispatches for {m['devchain_frames']} "
              f"frames)")
    finally:
        c.tpu_adaptive_wire, c.tpu_frames_per_dispatch, c.tpu_inflight = old
        at._streamed_cache.clear()


def phase_precision_streamed(dev, taps) -> dict:
    """27 (e): the spectrum chain streamed through ``TpuKernel`` with
    ``interior_precision="auto"`` at K = 1 and 4, held against the f32
    stream by SNR at the plan's floor; then mid-stream ``ctrl`` retunes of
    the FIR to ``off`` and back to ``auto``, each landing at a quiescent
    boundary with one capture of the new program, every frame emitted once."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops.stages import fft_stage, fir_stage, mag2_stage
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    from futuresdr_tpu_torch.types import Pmt
    inst = TpuInstance(dev)
    frame = FRAMES[0]
    n = PREC_STREAM_FRAMES * frame
    rng = np.random.default_rng(SEED + 30)
    data = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)
            ).astype(np.complex64)

    def stages():
        return [fir_stage(taps, name="fir"), fft_stage(N_FFT), mag2_stage()]

    def run(k, mode):
        fg = Flowgraph()
        tk = TpuKernel(stages(), np.complex64, frame_size=frame, inst=inst,
                       frames_in_flight=IN_FLIGHT, frames_per_dispatch=k, wire=LINK,
                       interior_precision=mode)
        snk = VectorSink(np.float32)
        fg.connect(VectorSource(data), tk, snk)
        t0 = time.perf_counter()
        Runtime().run(fg)
        return snk.items(), tk, n / (time.perf_counter() - t0) / 1e6

    out = {}
    ref, _tk, _ = run(1, "off")
    for k in (1, 4):
        got, tk, msps = run(k, "auto")
        plan = tk._precision_plan
        check(plan is not None and plan.lowered >= 1, "the auto kernel lowered nothing")
        floor = AB_BUDGET - 10 * np.log10(plan.lowered)
        snr = snr_db(torch.from_numpy(got), torch.from_numpy(ref))
        check(len(got) == len(ref) and snr >= floor,
              f"auto K={k}: {len(got)} items, {snr:.2f} dB against f32 (floor {floor:.2f})")
        check(tk._fn.captures == 1, f"auto K={k}: {tk._fn.captures} captures")
        out[k] = (msps, snr)
        print(f"precision streamed auto K={k}: {msps:.1f} input Msamples/s, {snr:.2f} dB "
              f"against the f32 stream (floor {floor:.2f} dB, lowered {plan.lowered})")
    # the mid-stream retunes: the source waits at each third of the stream
    # for its gate, a retune lands, one more frame passes the switch
    import threading
    third = PREC_STREAM_FRAMES // 3 * frame
    gates = [(third, threading.Event()), (third + frame, threading.Event()),
             (2 * third, threading.Event()), (2 * third + frame, threading.Event())]
    src = _gated_source(data, gates)
    tk = TpuKernel(stages(), np.complex64, frame_size=frame, inst=inst,
                   frames_in_flight=IN_FLIGHT, wire=LINK, interior_precision="auto")
    snk = VectorSink(np.float32)
    fg = Flowgraph()
    fg.connect(src, tk, snk)
    running = Runtime().start(fg)
    ok = False
    try:
        for i, (mode, switches) in enumerate((("off", 1), ("auto", 2))):
            _wait_for(lambda: len(snk.items()) == (i + 1) * third, "retune segment")
            r = running.handle.call_sync(tk, "ctrl", Pmt.map({
                "stage": "fir", "interior_precision": mode}))
            check(r == Pmt.ok(), f"ctrl interior_precision={mode}: {r}")
            gates[2 * i][1].set()
            _wait_for(lambda: tk.precision_switches == switches, "precision switch")
            check(tk._fn.captures == 1, f"the {mode} program captured {tk._fn.captures}x")
            gates[2 * i + 1][1].set()
        running.wait_sync()
        ok = True
    finally:
        if not ok:
            running.stop_sync()
    got = snk.items()
    check(len(got) == len(ref), f"retuned stream: {len(got)} items, want {len(ref)}")
    snr = snr_db(torch.from_numpy(got), torch.from_numpy(ref))
    check(snr >= AB_BUDGET - 10 * np.log10(2), f"retuned stream {snr:.2f} dB against f32")
    print(f"precision streamed retunes: fir auto -> off -> auto mid-stream, "
          f"{tk.precision_switches} switches at quiescent boundaries, one capture a "
          f"program, {snr:.2f} dB against the f32 stream")
    return out


def phase_precision_apps() -> None:
    """27 (g): the spectrum app's ``main()`` with ``--bf16`` and with
    ``--autotune``, each a subprocess on the card, exits 0."""
    import os
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    for flag in ("--bf16", "--autotune"):
        cmd = [sys.executable, "-m", "futuresdr_tpu_torch.apps.spectrum", flag,
               "--samples", str(APP_PREC_SAMPLES), "--ws-port", str(free_port())]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=MAIN_TIMEOUT_S,
                             env=env)
        tail = (res.stdout + res.stderr).strip().splitlines()[-1:] or [""]
        print(f"spectrum main {flag}: exit {res.returncode} after "
              f"{time.perf_counter() - t0:.1f} s ({tail[0][:160]})")
        check(res.returncode == 0, f"spectrum main {flag}: exit {res.returncode}:\n"
                                   f"{(res.stdout + res.stderr)[-4000:]}")


def phase_precision(dev, taps) -> dict:
    """Phase 27, precision and tuning: (a) the A/B matrix, (b) the int8
    rungs card against CPU, (c) the plan sweep, (d) the cache in the
    runtime, (e) streamed with retunes, (g) the app's flags; (f), the
    roofline, runs after phase 7's timings."""
    ab = phase_precision_ab(dev)
    phase_precision_int8(dev)
    sweep = phase_plan_sweep(dev)
    phase_cache_runtime(dev, taps)
    streamed = phase_precision_streamed(dev, taps)
    phase_precision_apps()
    return {"ab": ab, "sweep": sweep, "streamed": streamed}


def phase_roofline(rows) -> None:
    """27 (f): each kernel row's analytic bound (``utils/roofline``) equals
    PERF.md §6's Bound within 2%, and its measured share of the bound (bound
    over the card's time) is at most 1.05."""
    from futuresdr_tpu_torch.utils import roofline as R
    shapes = {"fir": lambda f: R.kernel_cost("fir", n=f, nt=N_TAPS),
              "fir_fft": lambda f: R.kernel_cost("fir_fft", n=f, nt=N_TAPS, n_fft=N_FFT),
              "rotator": lambda f: R.kernel_cost("rotator", n=f),
              "quad_demod": lambda f: R.kernel_cost("quad_demod", n=f // 4),
              "poly_fir/channel": lambda f: R.kernel_cost("poly_fir", n=f, m=32, D=4),
              "poly_fir/resampler": lambda f: R.kernel_cost(
                  "poly_fir", n=f // 4, m=2, D=125, I=24, complex=False),
              "pfb": lambda f: R.kernel_cost("pfb", n=f, N=PFB_N, K=12),
              "pfb/N=2048": lambda f: R.kernel_cost("pfb", n=f, N=PFB_WIDE_N, K=12),
              "poly_fir/decimator": lambda f: R.kernel_cost("poly_fir", n=f, m=8, D=16)}
    peaks = R.CHIP_PEAKS["h100"]

    def bound_us(kernel, f):
        if kernel == "poly_fir":
            return bound_us("poly_fir/channel", f) + bound_us("poly_fir/resampler", f)
        b, fl = shapes[kernel](f)
        return max(b / peaks["hbm_bytes"], fl / peaks["f32_flops"]) * 1e6

    for f, k, v in rows:
        key = (k, f)
        if key not in PERF_BOUND_US:
            continue
        mine = bound_us(k, f)
        share = mine / (v["ms"] * 1e3)
        print(f"roofline {k} n={f}: analytic bound {mine:.4f} us, PERF.md {PERF_BOUND_US[key]} "
              f"us, the script's {v['bound_ms'] * 1e3:.4f} us; kernel {v['ms'] * 1e3:.4f} us, "
              f"share of the bound {share:.3f}")
        check(abs(mine - PERF_BOUND_US[key]) <= 0.02 * PERF_BOUND_US[key] and
              abs(mine - v["bound_ms"] * 1e3) <= 0.02 * mine,
              f"roofline {k} n={f}: {mine:.4f} us against PERF.md's {PERF_BOUND_US[key]} "
              f"and the timing's {v['bound_ms'] * 1e3:.4f}")
        check(share <= 1.05, f"roofline {k} n={f}: {share:.3f} of the bound: the count is "
                             f"wrong")



# ---------------------------------------------------------------------------
# phase 28: the serving plane
# ---------------------------------------------------------------------------

SERVE_FRAME = 1 << 18          # the main chain served at its full frame
SERVE_BUCKETS = (1, 4, 16)
SERVE_SESSIONS = 16
SERVE_FRAMES_EACH = 3          # frames a session of (b)
SERVE_RETUNED = 4              # sessions given their own taps by lane retune
AB_FRAME = 512                 # serve_ab's chain and frame (perf/serve_ab.py)
AB_SESSIONS = 64
AB_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
AB_STEPS = 150                 # frame times of the churned run
AB_CHURN_EVENTS = 100          # joins and leaves (a close and an admit each)
AB_AB_STEPS = 40               # frame times of each A/B run
LANES = (1, 4, 64)
LANE_REPS = 8                  # distinct inputs a lane timing's graph
LANE_KERNELS = ("fir_lanes", "fir_fft_lanes", "rotator_lanes")
LANE_OF = {"fir_lanes": "fir", "fir_fft_lanes": "fir_fft", "rotator_lanes": "rotator"}
# the shapes of the kernels line: the main chain's (16 lanes of 2^18) for
# fir_fft_lanes, serve_ab's (64 lanes of 512) for fir_lanes and rotator_lanes
LANE_LINE_SHAPE = {"fir_fft_lanes": (SERVE_SESSIONS, SERVE_FRAME),
                   "fir_lanes": (AB_SESSIONS, AB_FRAME),
                   "rotator_lanes": (AB_SESSIONS, AB_FRAME)}


def serve_main_pipe(taps):
    from futuresdr_tpu_torch.ops.stages import Pipeline, fir_fft_stage, mag2_stage
    return Pipeline([fir_fft_stage(taps, N_FFT), mag2_stage()], np.complex64)


def serve_ab_pipe():
    from futuresdr_tpu_torch.ops.stages import Pipeline, fir_stage, rotator_stage
    return Pipeline([rotator_stage(0.013, impl="pallas"),
                     fir_stage(np.hanning(17).astype(np.float32), fft_len=128,
                               impl="pallas")], np.complex64)


def phase_serve_lanes(dev) -> dict:
    """28 (a): the lane forms of ``fir``, ``fir_fft`` and ``rotator`` at L = 1,
    4 and 64 with distinct taps, histories and phases a lane: each lane equal
    to the one-stream launch on its row bit for bit, and the lane plain
    version (on the card) within the kernel's tolerance. Returns the worst
    relative error a lane kernel."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    worst = dict.fromkeys(LANE_KERNELS, 0.0)

    def rc(*shape):
        return torch.randn(*shape, dtype=torch.complex64, generator=gen, device=dev)

    for L in LANES:
        for n, nt in ((AB_FRAME, 17), (SERVE_FRAME, N_TAPS)):
            x, hist = rc(L, n), rc(L, nt - 1)
            taps = torch.randn(L, nt, generator=gen, device=dev)
            y = ck.fir_lanes(hist, x, taps)
            per = torch.stack([ck.fir_continue(hist[i], x[i], taps[i]) for i in range(L)])
            check(torch.equal(y, per), f"fir_lanes L={L} n={n}: a lane differs from the "
                                       f"one-stream launch")
            _, rel = rel_err(y, ck.fir_lanes_plain(hist, x, taps))
            check(rel <= TOL["fir"], f"fir_lanes L={L} n={n}: {rel:.2e} from its plain version")
            worst["fir_lanes"] = max(worst["fir_lanes"], rel)
        n = SERVE_FRAME
        x, hist = rc(L, n), rc(L, N_TAPS - 1)
        taps = torch.randn(L, N_TAPS, generator=gen, device=dev)
        y = ck.fir_fft_lanes(hist, x, taps, N_FFT)
        per = torch.stack([ck.fir_fft(hist[i], x[i], taps[i], N_FFT) for i in range(L)])
        check(torch.equal(y, per), f"fir_fft_lanes L={L}: a lane differs from the "
                                   f"one-stream launch")
        _, rel = rel_err(y, ck.fir_fft_lanes_plain(hist, x, taps, N_FFT))
        check(rel <= TOL["fir_fft"], f"fir_fft_lanes L={L}: {rel:.2e} from its plain version")
        worst["fir_fft_lanes"] = max(worst["fir_fft_lanes"], rel)
        del x, hist, y, per
        for n in (AB_FRAME, AB_FRAME + 1):          # an odd row: the heads alternate
            x = rc(L, n)
            ph0 = torch.rand(L, generator=gen, device=dev) * 6.0
            inc = (torch.rand(L, generator=gen, device=dev) - 0.5) * 0.4
            y, nxt = ck.rotator_lanes(x, ph0, inc)
            per = [ck.rotator(x[i], ph0[i], inc[i]) for i in range(L)]
            check(torch.equal(y, torch.stack([p[0] for p in per])) and
                  torch.equal(nxt, torch.stack([p[1] for p in per])),
                  f"rotator_lanes L={L} n={n}: a lane differs from the one-stream launch")
            py, pn = ck.rotator_lanes_plain(x, ph0, inc)
            _, rel = rel_err(y, py)
            check(rel <= TOL["rotator"] and torch.equal(nxt, pn),
                  f"rotator_lanes L={L} n={n}: {rel:.2e} from its plain version")
            worst["rotator_lanes"] = max(worst["rotator_lanes"], rel)
    torch.cuda.synchronize()
    print(f"phase 28 (a): lane forms at L = {LANES} bit-equal to the one-stream launches; "
          f"worst against plain " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return worst


def _bare_outputs(pipe, frame, streams, dev, retunes=None):
    """Each stream through one compiled bare ``Pipeline`` from its own fresh
    carry (``retunes[i] = (at, stage, params)`` updates stream i's carry
    before frame ``at``): the served outputs' bit-equality reference."""
    import torch
    fn, _ = pipe.compile(frame, dev, donate=False)
    out = []
    for i, frames in enumerate(streams):
        carry = pipe.init_carry(dev)
        got = []
        for j, f in enumerate(frames):
            if retunes and i in retunes and retunes[i][0] == j:
                carry = pipe.update_stage(carry, retunes[i][1], **retunes[i][2])
            carry, y = fn(carry, torch.from_numpy(f).to(dev))
            got.append(y.cpu().numpy())
        out.append(got)
    torch.cuda.synchronize()
    return out


def _equal_streams(got, want, what: str) -> None:
    check(len(got) == len(want), f"{what}: {len(got)} outputs for {len(want)} frames")
    for j, (a, b) in enumerate(zip(got, want)):
        check(np.array_equal(a, b), f"{what}: frame {j} differs from the bare Pipeline "
                                    f"(max |diff| {float(np.max(np.abs(a - b))):.3e})")


def _stream_frames(rng, n_streams, n_frames, frame):
    return [[(rng.standard_normal(frame) + 1j * rng.standard_normal(frame))
             .astype(np.complex64) for _ in range(n_frames)] for _ in range(n_streams)]


def phase_serve_paths(dev, taps) -> dict:
    """28 (b) and (c): the engine's served paths. Their kernel launches are
    counted from 0 over the engines' runs alone; the bare references run
    before. Returns ``{"launches", "lat", "dispatch", "engines"}``."""
    import tempfile

    import torch

    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.serve import ServeEngine
    rng = np.random.default_rng(SEED + 280)
    # (b) the main chain at full width: 16 sessions of 2^18, four retuned
    main_data = _stream_frames(rng, SERVE_SESSIONS, SERVE_FRAMES_EACH, SERVE_FRAME)
    retaps = {i: firdes.lowpass(0.05 + 0.03 * i, N_TAPS).astype(np.float32)
              for i in range(SERVE_RETUNED)}
    stage = serve_main_pipe(taps).stages[0].name
    retunes = {i: (1, stage, {"taps": t}) for i, t in retaps.items()}
    main_ref = _bare_outputs(serve_main_pipe(taps), SERVE_FRAME, main_data, dev, retunes)
    # (c) serve_ab's chain: 64 sessions, 100 joins and leaves, an evict and
    # readmit round trip, and the persisted resume at in-flight depth 3
    n_joiners = AB_CHURN_EVENTS // 2
    ab_data = _stream_frames(rng, AB_SESSIONS + n_joiners, 12, AB_FRAME)
    per_data = _stream_frames(rng, 4, 6, AB_FRAME)
    per_ref = _bare_outputs(serve_ab_pipe(), AB_FRAME, per_data, dev)

    ck.reset_launches()
    eng = ServeEngine(serve_main_pipe(taps), frame_size=SERVE_FRAME, app="serve_main",
                      buckets=SERVE_BUCKETS, queue_frames=4, device=dev)
    sess = [eng.admit(tenant=f"t{i % 4}") for i in range(SERVE_SESSIONS)]
    check(eng.capacity == SERVE_BUCKETS[-1], f"the pool did not grow to "
                                             f"{SERVE_BUCKETS[-1]}: {eng.capacity}")
    for j in range(SERVE_FRAMES_EACH):
        if j == 1:
            for i, t in retaps.items():
                eng.retune(sess[i].sid, stage, taps=t)
        for s, d in zip(sess, main_data):
            check(eng.submit(s.sid, d[j]), "a main-chain submit was refused")
        check(eng.step() == SERVE_SESSIONS, "a main-chain step did not dispatch every lane")
    main_out = [eng.results(s.sid) for s in sess]
    check(eng.compiles == 1 and eng.dispatches == SERVE_FRAMES_EACH,
          f"main chain: {eng.compiles} builds, {eng.dispatches} dispatches")
    one = ServeEngine(serve_main_pipe(taps), frame_size=SERVE_FRAME, app="serve_n1",
                      buckets=(4,), queue_frames=4, device=dev)
    s1 = one.admit(tenant="solo")
    for f in main_data[SERVE_RETUNED]:
        check(one.submit(s1.sid, f), "an N = 1 submit was refused")
    while one.step():
        pass
    n1_out = one.results(s1.sid)

    ab = ServeEngine(serve_ab_pipe(), frame_size=AB_FRAME, app="serve_ab",
                     buckets=AB_BUCKETS, queue_frames=4, device=dev)
    owner = {}                       # sid -> stream index
    outs = {}                        # stream index -> outputs
    cursor = {}
    live = []
    for i in range(AB_SESSIONS):
        s = ab.admit(tenant=f"t{i % 4}")
        owner[s.sid], cursor[i], outs[i] = i, 0, []
        live.append(s)
    next_stream, events, busy, lat = AB_SESSIONS, 0, 0, []
    compiles_after_first = None
    evicted_round_trip = None
    for step in range(AB_STEPS):
        if step and events < AB_CHURN_EVENTS and step % 2 == 0:
            old = live.pop(step % len(live))
            outs[owner[old.sid]] += ab.results(old.sid)
            ab.close(old.sid)
            s = ab.admit(tenant=f"t{next_stream % 4}")
            owner[s.sid], cursor[next_stream], outs[next_stream] = next_stream, 0, []
            next_stream += 1
            live.append(s)
            events += 2
        if step == AB_STEPS // 2:    # evict and readmit one live session mid-stream
            victim = live[3]
            ab.evict(victim.sid)
            ab.readmit(victim.sid)
            evicted_round_trip = owner[victim.sid]
        for s in live:
            i = owner[s.sid]
            if cursor[i] < len(ab_data[i]):
                check(ab.submit(s.sid, ab_data[i][cursor[i]]), "a serve_ab submit was refused")
                cursor[i] += 1
        before = {s.sid: s.frames_out for s in live}
        n = ab.step()
        busy += bool(n)
        for s in live:
            if s.frames_out > before[s.sid] and s.last_latency_s is not None:
                lat.append(s.last_latency_s)
            outs[owner[s.sid]] += ab.results(s.sid)
        if compiles_after_first is None:
            compiles_after_first = ab.compiles
    while ab.step():
        busy += 1
    for s in live:
        outs[owner[s.sid]] += ab.results(s.sid)
    check(events >= AB_CHURN_EVENTS, f"only {events} join/leave events")
    check(ab.compiles == compiles_after_first == 1,
          f"churn built programs: {compiles_after_first} after the first step, "
          f"{ab.compiles} at the end")
    check(ab.dispatches == busy, f"{ab.dispatches} dispatches for {busy} busy frame times")
    with tempfile.TemporaryDirectory(dir=str(_build_dir())) as tmp:
        pa = ServeEngine(serve_ab_pipe(), frame_size=AB_FRAME, app="serve_persist",
                         buckets=(4,), queue_frames=8, device=dev, inflight=3,
                         persist_dir=tmp, persist_every=1)
        ps = [pa.admit(tenant="p", sid=f"p{i}") for i in range(4)]
        for j in range(3):
            for s, d in zip(ps, per_data):
                pa.submit(s.sid, d[j])
            pa.step()
        while pa.step():
            pass
        per_head = [pa.results(s.sid) for s in ps]
        pa.flush_persist()
        pb = ServeEngine(serve_ab_pipe(), frame_size=AB_FRAME, app="serve_persist",
                         buckets=(4,), queue_frames=8, device=dev, inflight=3,
                         persist_dir=tmp, persist_every=1)
        check(pb.restored_sessions == 4, f"{pb.restored_sessions} sessions restored")
        for j in range(3, 6):
            for i in range(4):
                pb.submit(f"p{i}", per_data[i][j])
            pb.step()
        while pb.step():
            pass
        per_tail = [pb.results(f"p{i}") for i in range(4)]
        pb.flush_persist()
    torch.cuda.synchronize()
    launches = {k: ck.launches[k] for k in ck.launches}

    # the comparisons, after the count
    for i in range(SERVE_SESSIONS):
        _equal_streams(main_out[i], main_ref[i], f"main chain session {i}"
                       + (" (retuned)" if i in retaps else ""))
    _equal_streams(n1_out, main_ref[SERVE_RETUNED], "main chain N = 1 in the capacity-4 "
                                                    "bucket")
    ab_ref = _bare_outputs(serve_ab_pipe(), AB_FRAME,
                           [ab_data[i][:len(outs[i])] for i in sorted(outs)], dev)
    for i in sorted(outs):
        _equal_streams(outs[i], ab_ref[i], f"serve_ab session {i}" +
                       (" (evicted and readmitted)" if i == evicted_round_trip else ""))
    for i in range(4):
        _equal_streams(per_head[i] + per_tail[i], per_ref[i],
                       f"persisted session p{i} at depth 3")
    print(f"phase 28 (b): {SERVE_SESSIONS} sessions of the main chain at {SERVE_FRAME} "
          f"({SERVE_RETUNED} retuned) and N = 1 in the capacity-4 bucket bit-equal to the "
          f"bare Pipeline; 1 build, {SERVE_FRAMES_EACH} dispatches")
    print(f"phase 28 (c): serve_ab chain, {AB_SESSIONS} sessions, {events} join/leave "
          f"events, {ab.dispatches} dispatches in {busy} busy frame times, builds "
          f"{ab.compiles} (resident bucket: 0 after the first); every stream, the "
          f"evict/readmit and the depth-3 persisted resume bit-equal")
    return {"launches": launches, "lat": lat, "engines": (eng, ab)}


def _graph_card_ms(prog) -> float:
    """One replay of a slot program's CUDA graph, card time (queued behind a
    device sleep), median of REPS."""
    import torch
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        prog._graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _run_independent(pipe, data, frame, dev, steps: int) -> float:
    """serve_ab's independent baseline: one compiled program, a carry a
    session, each frame time every session its own H2D, call and D2H;
    session-frames/s (median frame time)."""
    from futuresdr_tpu_torch.ops import xfer
    fn, _ = pipe.compile(frame, dev, donate=False)
    carries = [pipe.init_carry(dev) for _ in data]
    durs = []
    for step in range(steps):
        t0 = time.perf_counter()
        for i, d in enumerate(data):
            x = xfer.to_device(d[step % len(d)], dev)
            carries[i], y = fn(carries[i], x)
            xfer.to_host(y)
        durs.append(time.perf_counter() - t0)
    return len(data) / float(np.median(durs))


def _run_served(pipe, data, frame, dev, steps: int, app: str, k: int = 1,
                inflight: int = 1) -> tuple:
    """serve_ab's served side: every session rides one dispatch a frame
    time (``k`` frames a session a dispatch, ``inflight`` groups in flight);
    session-frames/s (median frame time) and the dispatches a frame time."""
    from futuresdr_tpu_torch.serve import ServeEngine
    eng = ServeEngine(pipe, frame_size=frame, app=app, buckets=(len(data),),
                      queue_frames=max(4, 2 * k), frames_per_dispatch=k, device=dev,
                      inflight=inflight)
    sess = [eng.admit(tenant=f"t{i % 4}") for i in range(len(data))]
    for s, d in zip(sess, data):
        for j in range(k):
            eng.submit(s.sid, d[j % len(d)])
    eng.step()
    while eng.step():
        pass
    durs, d0 = [], eng.dispatches
    for step in range(1, steps + 1):
        t0 = time.perf_counter()
        for s, d in zip(sess, data):
            for j in range(k):
                eng.submit(s.sid, d[(step * k + j) % len(d)])
        eng.step()
        for s in sess:
            eng.results(s.sid)
        durs.append(time.perf_counter() - t0)
    while eng.step():
        pass
    return len(data) * k / float(np.median(durs)), (eng.dispatches - d0) / steps


def phase_serve_measure(dev, taps, paths, card_line) -> dict:
    """28 (d), printed figures, no claim: autotune_serve's ladder and rates,
    one dispatch's card time, submit→result p99 under churn, and the served
    sessions against as many independent compiled loops."""
    from futuresdr_tpu_torch.tpu import TpuInstance
    from futuresdr_tpu_torch.tpu.autotune import autotune_serve
    inst = TpuInstance(dev)
    for label, pipe, frame, caps in (
            ("main chain", serve_main_pipe(taps), SERVE_FRAME, (1, 2, 4, 8, 16)),
            ("serve_ab chain", serve_ab_pipe(), AB_FRAME, AB_BUCKETS)):
        ladder, rates = autotune_serve(pipe, frame_size=frame, inst=inst, capacities=caps,
                                       reps=10, record=False)
        print(f"serve autotune {label} frame={frame}: ladder {ladder}; " + ", ".join(
            f"capacity {c}: {r:.1f} session-frames/s" for c, r in sorted(rates.items()))
            + f" [{card_line}]")
    eng_main, eng_ab = paths["engines"]
    out = {}
    for label, eng in (("main chain", eng_main), ("serve_ab chain", eng_ab)):
        (cap, k, _tag), prog = next(iter(eng._programs.items()))
        ms = _graph_card_ms(prog)
        out[label] = ms
        print(f"serve dispatch {label} capacity {cap} frame={eng.frame_size}: card "
              f"{ms:.4f} ms a dispatch ({ms * 1e3 / cap:.2f} us a session-frame), "
              f"{prog.launches} [{card_line}]")
    lat = np.asarray(paths["lat"]) * 1e3
    print(f"serve p99 submit->result serve_ab chain under churn ({AB_SESSIONS} sessions, "
          f"{AB_CHURN_EVENTS} join/leave events): {np.percentile(lat, 99):.3f} ms "
          f"(p50 {np.percentile(lat, 50):.3f} ms, {lat.size} frames) [{card_line}]")
    rng = np.random.default_rng(SEED + 281)
    for label, mk, frame, n in (("serve_ab chain", serve_ab_pipe, AB_FRAME, AB_SESSIONS),
                                ("main chain", lambda: serve_main_pipe(taps), SERVE_FRAME,
                                 SERVE_SESSIONS)):
        data = _stream_frames(rng, n, 4, frame)
        indep = _run_independent(mk(), data, frame, dev, AB_AB_STEPS)
        served, disp = _run_served(mk(), data, frame, dev, AB_AB_STEPS, f"ab_{frame}")
        out[f"ab {label}"] = (served, indep)
        print(f"serve A/B {label} frame={frame} sessions={n}: served {served:.1f}, "
              f"independent {indep:.1f} session-frames/s, ratio {served / indep:.2f}, "
              f"{disp:g} dispatches a frame time [{card_line}]")
        for k, depth in ((4, 1), (1, 3)):
            got, disp = _run_served(mk(), data, frame, dev, AB_AB_STEPS // k,
                                    f"ab_{frame}_{k}_{depth}", k=k, inflight=depth)
            out[f"served {label} K={k} depth={depth}"] = got
            print(f"serve {label} frame={frame} sessions={n} K={k} in-flight={depth}: "
                  f"{got:.1f} session-frames/s, {got / served:.2f} x K=1 depth 1, "
                  f"{disp:g} dispatches a frame time [{card_line}]")
    return out


def lane_timings(dev, name: str, L: int, n: int) -> dict:
    """Kernel, plain and library device time and the bound of a lane form on
    ``L`` lanes of ``n`` complex64 samples (``fir``: 64 taps at 2^18, 17 at
    512; ``fir_fft``: 64 taps, N = 2048)."""
    import torch
    import torch.nn.functional as F

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.utils.roofline import kernel_cost
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    nt = 17 if n == AB_FRAME else N_TAPS

    def rc(*shape):
        return torch.randn(*shape, dtype=torch.complex64, generator=gen, device=dev)

    if name == "rotator_lanes":
        args = [(rc(L, n), torch.rand(L, generator=gen, device=dev) * 6,
                 torch.rand(L, generator=gen, device=dev) * 0.1) for _ in range(LANE_REPS)]
        kern, plain, lib = ck.rotator_lanes, ck.rotator_lanes_plain, None
        nbytes, ops = kernel_cost("rotator", n=n)
        nbytes, ops = L * nbytes, L * ops
    else:
        args = [(rc(L, nt - 1), rc(L, n), torch.randn(L, nt, generator=gen, device=dev))
                for _ in range(LANE_REPS)]
        w = [a[2].flip(1).repeat_interleave(2, 0).unsqueeze(1).contiguous() for a in args]
        planes = [(torch.view_as_real(torch.cat([h, x], dim=1)).permute(0, 2, 1)
                   .reshape(1, 2 * L, -1).contiguous(), wi) for (h, x, _), wi in zip(args, w)]
        if name == "fir_lanes":
            kern, plain = ck.fir_lanes, ck.fir_lanes_plain

            def lib(p, wi):
                return F.conv1d(p, wi, groups=2 * L)
            nbytes, ops = kernel_cost("fir", n=n, nt=nt)
            nbytes, ops = L * nbytes, L * ops
        else:
            def kern(h, x, t):
                return ck.fir_fft_lanes(h, x, t, N_FFT)

            def plain(h, x, t):
                return ck.fir_fft_lanes_plain(h, x, t, N_FFT)

            def lib(p, wi):
                y = F.conv1d(p, wi, groups=2 * L).view(L, 2, -1)
                return torch.fft.fft(torch.complex(y[:, 0], y[:, 1]).view(L, -1, N_FFT), dim=2)
            nbytes, ops = kernel_cost("fir_fft", n=n, nt=nt, n_fft=N_FFT)
            nbytes, ops = L * nbytes - (L - 1) * N_FFT * 8, L * ops
    got = kern(*args[0])
    ref = plain(*args[0])
    err, _ = rel_err(got[0] if isinstance(got, tuple) else got,
                     ref[0] if isinstance(ref, tuple) else ref)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    out = {"ms": device_ms(kern, args), "plain_ms": device_ms(plain, args[:2]),
           "library_ms": None if lib is None else device_ms(lib, planes),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "max_abs_err": err}
    if lib is None:
        out["copy_ms"] = device_ms(lambda x, *_: x.clone(), args)
    return out


def phase_serving(dev, taps, card_line) -> dict:
    """Phase 28, the serving plane: (a) the lane kernels, (b) the main chain
    served at full width, (c) serve_ab's chain under churn, evict/readmit and
    the persisted resume, (d) printed figures; lane timings for the kernels
    line."""
    t0 = time.perf_counter()
    worst = phase_serve_lanes(dev)
    paths = phase_serve_paths(dev, taps)
    measured = phase_serve_measure(dev, taps, paths, card_line)
    timings = {}
    for name in LANE_KERNELS:
        shapes = {LANE_LINE_SHAPE[name], (SERVE_SESSIONS, SERVE_FRAME)}
        for L, n in sorted(shapes):
            t = lane_timings(dev, name, L, n)
            timings[(name, L, n)] = t
            lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
            yard = f", copy of its bytes {t['copy_ms']:.4f} ms" if "copy_ms" in t else ""
            print(f"timing {name} L={L} n={n}: kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, library {lib}, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}){yard} [{card_line}]")
    print(f"phase 28: {time.perf_counter() - t0:.1f} s")
    return {"worst": worst, "launches": paths["launches"], "timings": timings,
            "measured": measured}


# ---------------------------------------------------------------------------
# phase 29: the models' device plane
# ---------------------------------------------------------------------------

VIT_BATCHES = (1, 8, 256)
VIT_BUCKETS = (8, 512, 4096)
VIT_LINE = (256, 4096)           # the kernels line's shape: perf/wlan.py's batch
VIT_REPS = 4                     # distinct inputs a timing's graph (67 MB of picks each)
WLAN_FRAMES = 200                # perf/wlan.py's stream
WLAN_PAYLOAD = 256
WLAN_GAP = 300
WLAN_SNR_DB = 25.0
WLAN_CFO = 0.002                 # rad/sample, the demod checks' carrier offset
DEMOD_BUCKET = 1024              # perf/wlan.py --device-resident's symbols a frame
DEMOD_MODS = ("bpsk", "qpsk", "qam16", "qam64")
DEMOD_MCS = {"bpsk": "bpsk_1_2", "qpsk": "qpsk_1_2", "qam16": "qam16_1_2",
             "qam64": "qam64_3_4"}
# the card against the CPU: cuFFT, the card's sincos/atan2 and sums in
# another order move the float32 results in their last bits
HEAD_H_TOL = 2e-4                # tests/test_wlan.py's bar for the head
HEAD_LLR_TOL = 2e-3
BODY_LLR_TOL = 2e-4              # LLRs reach about 8: 2e-4 is ~200 ulps there
LOOPBACK_FRAMES = 10
MCLDNN_TOL = 1e-4                # logits reach about 12, float32 with TF32 off
MCLDNN_WINDOWS = 256
MCLDNN_ACC = 0.9                 # tests/test_pretrained.py's bar
CLF_SNR_DB = 15.0
CLF_SHARE = 0.7                  # tests/test_pretrained.py's bar
REPLACES_VITERBI = ("futuresdr_tpu/ops/viterbi.py:31 (lax.scan, no pallas_call) and its "
                    "host traceback :105")
SOURCE_VITERBI = "futuresdr_tpu_torch/csrc/viterbi.cu"
# 802.11's 64 states and M17's 16 (the butterfly route), 802.11's relabelled
# by a seeded state permutation that keeps state 0 (the generic route)
VIT_TRELLISES = ("wlan", "m17", "relabelled")
# the first design's figures at VIT_LINE (PERF.md §6), printed beside today's,
# not measured here
VIT_FIRST_DESIGN = "kernel 332.5-335.1 us, one frame 327.1-329.5 us, step chain 186.0-187.3 us"


def _trellis(dev, name: str = "wlan"):
    """``(prev_s, prev_b, bm0, bm1)`` of ``name`` (``VIT_TRELLISES``) on
    ``dev`` (int32, int32, float32, float32)."""
    import torch

    from futuresdr_tpu_torch.models.m17 import codec
    from futuresdr_tpu_torch.models.wlan import coding
    tables = (coding._PREV_S, coding._PREV_B, coding._BM0, coding._BM1)
    if name == "m17":
        tables = codec._M17_PREV
    elif name == "relabelled":
        sigma = np.concatenate([[0], 1 + np.random.default_rng(16).permutation(63)])
        out = [np.empty_like(t) for t in tables]
        out[0][sigma] = sigma[tables[0]]
        for o, t in zip(out[1:], tables[1:]):
            o[sigma] = t
        tables = out
    return tuple(torch.from_numpy(np.ascontiguousarray(t, dt)).to(dev)
                 for t, dt in zip(tables, (np.int32, np.int32, np.float32, np.float32)))


def _codeword_lams(gen, batch: int, steps: int, dev, name: str = "wlan"):
    """Noisy soft bits of random terminated codewords of the butterfly
    trellis ``name``, ``[batch, steps, 2]`` on ``dev``: from state s, input b
    leads to state b·S/2 + s // 2, whose candidate s % 2 carries the branch's
    ±1 output pair."""
    import torch

    prev_s, _, bm0, bm1 = (t.cpu().numpy() for t in _trellis("cpu", name))
    half = prev_s.shape[0] // 2
    rng = np.random.default_rng(int(torch.randint(1 << 30, (1,), generator=gen)))
    bits = rng.integers(0, 2, (batch, steps))
    bits[:, -7:] = 0
    coded = np.empty((batch, steps, 2), np.float32)
    s = np.zeros(batch, np.int64)
    for t in range(steps):
        nxt = bits[:, t] * half + s // 2
        coded[:, t, 0], coded[:, t, 1] = bm0[nxt, s % 2], bm1[nxt, s % 2]
        s = nxt
    coded += 0.9 * rng.standard_normal(coded.shape).astype(np.float32)
    return torch.from_numpy(coded).to(dev)


def phase_viterbi_kernel(dev, card_line, empty_lib) -> dict:
    """29 (a): the decoder kernel against its plain versions at every
    trellis of ``VIT_TRELLISES``, (B, bucket) and on noisy codewords and
    all-zero LLRs (every compare a tie), on ragged frames (each its own
    length, the first the whole bucket): its survivors, unpacked, equal
    ``acs_plain``'s picks bit for bit for t < steps[b], its decoded bits the
    plain traceback's. Then its time at B 256 × 4096 (the recursion and the
    traceback; the recursion alone; one frame alone; 16 states; the generic
    route) beside the plain versions, its bound and its sequential floor:
    the step chain alone (``EMPTY_CU``'s ``acs_chain_kernel``)."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops import viterbi as V
    from futuresdr_tpu_torch.utils.roofline import kernel_cost
    gen = torch.Generator().manual_seed(SEED + 290)
    rng = np.random.default_rng(SEED + 290)
    err = 0
    for name in VIT_TRELLISES:
        ps, pb, b0, b1 = _trellis(dev, name)
        S = int(ps.shape[0])
        for B in VIT_BATCHES:
            for T in VIT_BUCKETS:
                steps_np = rng.integers(T // 2, T + 1, B).astype(np.int32)
                steps_np[0] = T
                steps = torch.from_numpy(steps_np).to(dev)
                live = (torch.arange(T, device=dev)[:, None] < steps[None, :])[..., None]
                code = "m17" if name == "m17" else "wlan"
                for label, lams in (("noisy", _codeword_lams(gen, B, T, dev, code)),
                                    ("zero", torch.zeros(B, T, 2, device=dev))):
                    picks = V.unpack_survivors(V.survivors(lams, steps, ps, b0, b1), S)
                    bits = V.decode(lams, steps, ps, pb, b0, b1)
                    torch.cuda.synchronize()
                    want = V.acs_plain(lams, ps, b0, b1) * live
                    want_bits = V.traceback_plain(V.pack_survivors(want), steps, ps, pb)
                    err = max(err, int((picks.int() - want.int()).abs().max()),
                              int((bits.int() - want_bits.int()).abs().max()))
                    diff = int((picks != want).sum())
                    check(diff == 0, f"viterbi {name} B={B} T={T} {label}: {diff} picks "
                                     f"differ from the plain version")
                    diff = int((bits != want_bits).sum())
                    check(diff == 0, f"viterbi {name} B={B} T={T} {label}: {diff} decoded "
                                     f"bits differ from the plain traceback")
                    check(label != "zero" or not (picks.any() or bits.any()),
                          f"viterbi {name} B={B} T={T}: a tie did not pick candidate 0")
        print(f"viterbi {name} ({S} states): survivors equal acs_plain and decoded bits "
              f"the plain traceback at B {VIT_BATCHES} x buckets {VIT_BUCKETS}, ragged "
              f"lengths, noisy and all-zero LLRs")
    B, T = VIT_LINE
    tables = _trellis(dev)
    ps, pb, b0, b1 = tables
    full = torch.full((B,), T, dtype=torch.int32, device=dev)
    args = [(_codeword_lams(gen, B, T, dev),) for _ in range(VIT_REPS)]
    ms = device_ms(lambda x: V.decode(x, full, *tables), args)
    surv = torch.empty((B, T, 2), dtype=torch.int32, device=dev)
    acs_ms = device_ms(lambda x: V._launch(x, full, ps, b0, b1, None, surv, None), args)
    one_frame = device_ms(lambda x: V.decode(x[:1], full[:1], *tables), args)
    generic = _trellis(dev, "relabelled")
    generic_ms = device_ms(lambda x: V.decode(x, full, *generic), args)
    m17 = _trellis(dev, "m17")
    args16 = [(_codeword_lams(gen, B, T, dev, "m17"),) for _ in range(VIT_REPS)]
    ms16 = device_ms(lambda x: V.decode(x, full, *m17), args16)

    def plain(x, tb):
        words = V.pack_survivors(V.acs_plain(x, tb[0], tb[2], tb[3]))
        return V.traceback_plain(words, full, tb[0], tb[1])
    plain_ms = cuda_ms(lambda: plain(args[0][0], tables), reps=3)
    plain16_ms = cuda_ms(lambda: plain(args16[0][0], m17), reps=1)
    chain_out = torch.empty(96, dtype=torch.float32, device=dev)

    def chain():
        ck._raise_on(empty_lib.fsdr_acs_chain(b0.data_ptr(), b1.data_ptr(),
                                              chain_out.data_ptr(), T, ck._stream(chain_out)),
                     "acs_chain")
    floor_ms = device_ms(chain, [()] * VIT_REPS)
    nbytes, ops = kernel_cost("viterbi", B=B, T=T)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    nbytes16, ops16 = kernel_cost("viterbi", B=B, T=T, S=16)
    t = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
         "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "max_abs_err": float(err), "seq_floor_ms": floor_ms, "one_frame_ms": one_frame,
         "acs_ms": acs_ms, "generic_ms": generic_ms, "states16_ms": ms16,
         "states16_plain_ms": plain16_ms,
         "bound16_ms": max(nbytes16 / PEAK_BYTES, ops16 / PEAK_FP32) * 1e3}
    print(f"timing viterbi B={B} T={T} 64 states: kernel (recursion and traceback) "
          f"{ms:.4f} ms, recursion alone {acs_ms:.4f} ms, plain (acs_plain, pack, "
          f"traceback_plain) {plain_ms:.4f} ms, library none, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}), one frame alone {one_frame:.4f} ms "
          f"({one_frame * 1e6 / T:.1f} ns a step), generic route (relabelled tables) "
          f"{generic_ms:.4f} ms, sequential floor (the step chain alone, one warp) "
          f"{floor_ms:.4f} ms ({floor_ms * 1e6 / T:.1f} ns a step); the first design "
          f"(PERF.md, not measured here): {VIT_FIRST_DESIGN} [{card_line}]")
    print(f"timing viterbi B={B} T={T} 16 states (M17): kernel {ms16:.4f} ms, plain "
          f"{plain16_ms:.4f} ms, bound {t['bound16_ms']:.4f} ms [{card_line}]")
    return t


def _wlan_frame(mcs: str, n_sym: int, seed: int):
    """One noisy ``mcs`` burst of ``n_sym`` data symbols with carrier offset
    ``WLAN_CFO``; returns ``(samples, lts_start, cfo)``."""
    from futuresdr_tpu_torch.models import wlan as W
    from futuresdr_tpu_torch.models.wlan import ofdm
    m = W.MCS_TABLE[mcs]
    rng = np.random.default_rng(seed)
    nbytes = (n_sym * m.n_dbps - 22) // 8
    sig = W.encode_frame(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes(), mcs)
    sig = np.concatenate([np.zeros(100, np.complex64), sig, np.zeros(100, np.complex64)])
    sig = sig * np.exp(1j * WLAN_CFO * np.arange(len(sig)))
    sig = (sig + 0.02 * (rng.standard_normal(len(sig))
                         + 1j * rng.standard_normal(len(sig)))).astype(np.complex64)
    _, lts, cfo = ofdm.sync_long(sig, ofdm.detect_packets(sig)[0])
    return sig, lts, cfo


def phase_wlan_demod(dev, card_line) -> dict:
    """29 (b): the head and body demod on the card against the CPU for each
    modulation; the body at a 1,024-symbol bucket (81,920 samples): its card
    time (``demod_body_tensors`` replayed in a CUDA graph on inputs already on
    the card) and the host time of a ``demod_body_torch`` call as the receiver
    makes it (numpy in, the pad and the H2D, eager ops, the LLRs' D2H)."""
    import torch

    from futuresdr_tpu_torch.models.wlan import torch_demod as TD
    worst = {"H": 0.0, "head": 0.0, "body": 0.0}
    for i, mod in enumerate(DEMOD_MODS):
        for n_sym in (8, 37):
            sig, lts, cfo = _wlan_frame(DEMOD_MCS[mod], n_sym, 29 + i)
            head = sig[lts:lts + 208]
            Hg, lg = TD.demod_head_torch(head, cfo, dev)
            Hc, lc = TD.demod_head_torch(head, cfo, "cpu")
            worst["H"] = max(worst["H"], float(np.abs(Hg - Hc).max()))
            worst["head"] = max(worst["head"], float(np.abs(lg - lc).max()))
            off = lts + 208
            args = (sig[off:off + n_sym * 80], Hc, n_sym, 1, cfo, off - lts, mod)
            bg, bc = TD.demod_body_torch(*args, dev), TD.demod_body_torch(*args, "cpu")
            check(bg.shape == bc.shape == (n_sym * 48 * {"bpsk": 1, "qpsk": 2, "qam16": 4,
                                                         "qam64": 6}[mod],),
                  f"demod body {mod}: shape {bg.shape}")
            worst["body"] = max(worst["body"], float(np.abs(bg - bc).max()))
    print(f"demod card vs CPU: H {worst['H']:.3g} (limit {HEAD_H_TOL}), head LLRs "
          f"{worst['head']:.3g} (limit {HEAD_LLR_TOL}), body LLRs {worst['body']:.3g} "
          f"(limit {BODY_LLR_TOL})")
    check(worst["H"] <= HEAD_H_TOL and worst["head"] <= HEAD_LLR_TOL
          and worst["body"] <= BODY_LLR_TOL, f"demod on the card against the CPU: {worst}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 291)
    n = DEMOD_BUCKET * 80
    H = torch.from_numpy(np.ones(64, np.complex64)).to(dev)
    H = H + 0.3 * torch.randn(64, dtype=torch.complex64, generator=gen, device=dev)
    pol, mask = TD.body_inputs(DEMOD_BUCKET, 1, dev)
    args = [(randc(n, gen, dev),) for _ in range(REPS)]
    body_np, H_np = args[0][0].cpu().numpy(), H.cpu().numpy()
    rates = {}
    for mod in DEMOD_MODS:
        ms = device_ms(lambda x: TD.demod_body_tensors(x, H, pol, mask, 1e-4, 0.0, mod),
                       args)
        TD.demod_body_torch(body_np, H_np, DEMOD_BUCKET, 1, 1e-4, 0.0, mod, dev)
        host = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            TD.demod_body_torch(body_np, H_np, DEMOD_BUCKET, 1, 1e-4, 0.0, mod, dev)
            host.append((time.perf_counter() - t0) * 1e3)
        eager_ms = statistics.median(host)
        rates[mod] = (ms, n / (ms * 1e3), eager_ms, n / (eager_ms * 1e3))
        print(f"timing demod body {mod} bucket={DEMOD_BUCKET} ({n} samples): card "
              f"{ms:.4f} ms ({n / (ms * 1e3):.1f} input Msamples/s, graph replay); "
              f"demod_body_torch eager {eager_ms:.4f} ms host time a call "
              f"({n / (eager_ms * 1e3):.1f} input Msamples/s) [{card_line}]")
    return {"worst": worst, "rates": rates}


def wlan_stream():
    """``perf/wlan.py``'s stream: seed 0, ``WLAN_FRAMES`` QPSK-1/2 MPDUs of
    ``WLAN_PAYLOAD`` random bytes, ``WLAN_GAP``-sample gaps, ``WLAN_SNR_DB``."""
    from futuresdr_tpu_torch.models import wlan as W
    rng = np.random.default_rng(0)
    mac = W.Mac()
    parts, sent = [], []
    for _ in range(WLAN_FRAMES):
        psdu = mac.frame(bytes(rng.integers(0, 256, WLAN_PAYLOAD, dtype=np.uint8)))
        sent.append(psdu)
        parts += [W.encode_frame(psdu, "qpsk_1_2"), np.zeros(WLAN_GAP, np.complex64)]
    sig = np.concatenate(parts)
    sigma = np.sqrt(np.mean(np.abs(sig) ** 2) * 10 ** (-WLAN_SNR_DB / 10) / 2)
    sig = (sig + sigma * (rng.standard_normal(len(sig))
                          + 1j * rng.standard_normal(len(sig)))).astype(np.complex64)
    return sig, sent


def phase_wlan_stream(dev, card_line) -> dict:
    """29 (c): the stream through ``decode_stream_batch`` on the card (one
    warm-up, then the timed run): every frame decoded, its FCS good, equal to
    what was sent. (d): the loopback app's ``main()`` on the card. The ACS
    kernel's launches are counted over (c)'s timed run and (d)."""
    import torch

    from futuresdr_tpu_torch.apps import wlan_loopback
    from futuresdr_tpu_torch.models import wlan as W
    from futuresdr_tpu_torch.ops import viterbi as V
    sig, sent = wlan_stream()
    W.decode_stream_batch(sig, device=dev)
    torch.cuda.synchronize()
    stats = {}
    V.reset_launches()
    t0 = time.perf_counter()
    frames = W.decode_stream_batch(sig, device=dev, stats=stats)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = V.launches["viterbi"]
    good = [f for f in frames if W.payload_from_mpdu(f.psdu) is not None]
    check(len(good) == WLAN_FRAMES and [f.psdu for f in frames] == sent,
          f"wlan stream: {len(good)} of {WLAN_FRAMES} frames decoded with a good FCS")
    print(f"rate wlan stream decode_stream_batch ({WLAN_FRAMES} QPSK-1/2 frames, "
          f"{WLAN_PAYLOAD} B, {WLAN_SNR_DB:g} dB, {len(sig)} samples): {len(good)}/"
          f"{WLAN_FRAMES} frames, {dt:.3f} s, {len(good) / dt:.1f} frames/s, "
          f"{len(sig) / dt / 1e6:.3f} Msamples/s; decoder ({stats['frames']} frames x "
          f"{stats['bucket']} steps) H2D, recursion and traceback "
          f"{stats['acs_s'] * 1e3:.2f} ms, decoded bits D2H {stats['d2h_bytes']} B in "
          f"{stats['d2h_s'] * 1e3:.2f} ms (the first design sent the picks: 134217728 B "
          f"in 58.2-65.7 ms, PERF.md) [{card_line}]")
    V.reset_launches()
    rc = wlan_loopback.main(["--frames", str(LOOPBACK_FRAMES), "--device", str(dev)])
    torch.cuda.synchronize()
    check(rc == 0, f"wlan loopback on the card: exit {rc}, not {LOOPBACK_FRAMES} of "
                   f"{LOOPBACK_FRAMES} frames")
    launches += V.launches["viterbi"]
    check(launches > 0, "the viterbi kernel was launched no time on the WLAN path")
    return {"launches": launches, "frames_s": len(good) / dt, "msps": len(sig) / dt / 1e6,
            "stats": stats}


def phase_mcldnn(dev, card_line) -> dict:
    """29 (e): the pretrained MCLDNN on the card against the CPU port (TF32
    off), its accuracy, ``ModClassifier`` in a flowgraph on the card, and a
    256-window forward's time."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.models import modrec
    from futuresdr_tpu_torch.models.mcldnn import loss_fn
    X, y = modrec.synth_batch(np.random.default_rng(42), MCLDNN_WINDOWS, 128, (10.0, 20.0))
    card_model = modrec.load_pretrained(device=dev)
    cpu_model = modrec.load_pretrained(device="cpu")
    xd = torch.from_numpy(X).to(dev)
    with torch.inference_mode():
        got = card_model(xd).cpu().numpy()
        want = cpu_model(torch.from_numpy(X)).numpy()
        _, acc = loss_fn(card_model, xd, torch.from_numpy(y).to(dev))
    err = float(np.abs(got - want).max())
    check(err <= MCLDNN_TOL, f"mcldnn logits on the card: {err:.3g} from the CPU's "
                             f"(limit {MCLDNN_TOL})")
    check(float(acc) > MCLDNN_ACC, f"mcldnn accuracy on the card {float(acc):.4f}")
    rng = np.random.default_rng(1)
    x = modrec._psk_qam(rng, 64 * 128, "qpsk")
    x = x / np.sqrt(np.mean(np.abs(x) ** 2))
    sigma = np.sqrt(10 ** (-CLF_SNR_DB / 10) / 2)
    x = (x + sigma * (rng.standard_normal(len(x))
                      + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
    fg = Flowgraph()
    clf = modrec.ModClassifier(card_model, n=128, batch=8, device=dev)
    fg.connect_stream(VectorSource(x), "out", clf, "in")
    Runtime().run(fg)
    labels = [c for c, _ in clf.predictions]
    share = labels.count("qpsk") / max(len(labels), 1)
    check(len(labels) == 64 and share >= CLF_SHARE,
          f"ModClassifier on the card: {labels.count('qpsk')} of {len(labels)} qpsk")

    def forward():
        with torch.inference_mode():
            return card_model(xd)
    ms = cuda_ms(forward)
    print(f"mcldnn: logits {err:.3g} from the CPU (limit {MCLDNN_TOL}), accuracy "
          f"{float(acc):.4f}, ModClassifier {labels.count('qpsk')}/{len(labels)} qpsk; "
          f"{MCLDNN_WINDOWS}-window forward {ms:.4f} ms, "
          f"{MCLDNN_WINDOWS / ms * 1e3:.0f} windows/s [{card_line}]")
    return {"err": err, "acc": float(acc), "ms": ms, "share": share}


def phase_models(dev, card_line, empty_lib) -> dict:
    """Phase 29, the models' device plane: (a) the Viterbi kernel, (b) the
    demod, (c) perf/wlan.py's stream, (d) the loopback app, (e) MCLDNN."""
    t0 = time.perf_counter()
    viterbi = phase_viterbi_kernel(dev, card_line, empty_lib)
    demod = phase_wlan_demod(dev, card_line)
    stream = phase_wlan_stream(dev, card_line)
    mcldnn = phase_mcldnn(dev, card_line)
    print(f"phase 29: {time.perf_counter() - t0:.1f} s")
    return {"viterbi": viterbi, "demod": demod, "stream": stream, "mcldnn": mcldnn}


def decimator_timings(dev) -> dict:
    """Kernel, plain and library (``conv1d``) device time and the bound of the
    decimating ``poly_fir`` of the precision matrix's decimator (D = 16,
    m = 8, complex64) at 2^18."""
    import torch
    import torch.nn.functional as F

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.utils.roofline import kernel_cost
    n, D, m = 1 << 18, 16, 8
    gen = torch.Generator(device=dev).manual_seed(SEED + 292)
    W = torch.randn(m + 1, D, generator=gen, device=dev)
    args = [(randc(m * D, gen, dev), randc(n, gen, dev)) for _ in range(REPS)]
    cw = W.flip(0).t().unsqueeze(0).contiguous()             # [1, D, m + 1]
    lib_args = [(torch.view_as_real(torch.cat([h, x])).reshape(-1, D, 2)
                 .permute(2, 1, 0).contiguous(),) for h, x in args]
    err, _ = rel_err(ck.poly_fir(*args[0], W), ck.poly_fir_plain(*args[0], W))
    nbytes, ops = kernel_cost("poly_fir", n=n, m=m, D=D)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return {"ms": device_ms(lambda h, x: ck.poly_fir(h, x, W), args),
            "plain_ms": device_ms(lambda h, x: ck.poly_fir_plain(h, x, W), args),
            "library_ms": device_ms(lambda p: F.conv1d(p, cw), lib_args),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "max_abs_err": err}


# A phase that stalls past this many seconds dumps every thread's stack to
# stderr and ends the run (exit 1), inside the 1200 s a run may take.
WATCHDOG_S = 1100


# --stress N: each streamed phase's run that takes longer than this dumps
# every thread's stack, then (if the interpreter is free) every pending
# asyncio task's stack and the state of every block inbox and ring, and exits.
STRESS_STALL_S = 60


def _stall_report(what: str) -> None:
    """Print the pending asyncio tasks, block inboxes and rings, then exit."""
    import asyncio
    import gc
    import os

    from futuresdr_tpu_torch.runtime.block import WrappedKernel
    from futuresdr_tpu_torch.runtime.buffer.circular import CircularWriter
    from futuresdr_tpu_torch.runtime.buffer.ring import RingWriter
    from futuresdr_tpu_torch.tpu import TpuKernel
    err = sys.stderr
    print(f"chip_smoke: STALL in {what}; state of the live objects:", file=err)
    warnings.simplefilter("ignore")     # lazy torch attributes warn on isinstance
    gc.collect()
    for o in gc.get_objects():
        if isinstance(o, asyncio.Task) and not o.done():
            print(f"task {o.get_name()}:", file=err)
            o.print_stack(file=err)
        elif isinstance(o, WrappedKernel):
            ib, k = o.inbox, o.kernel
            extra = ""
            if isinstance(k, TpuKernel):
                extra = (f" staged {len(k._staged)} inflight {len(k._inflight)} "
                         f"pending_out {k._pending_out is not None} "
                         f"dispatched {k.frames_dispatched}")
            print(f"block {o.instance_name}: pending {ib._pending} queued "
                  f"{list(ib._q)} waiter {ib._waiter is not None} closed "
                  f"{ib.closed}{extra}", file=err)
        elif isinstance(o, RingWriter):
            print(f"ring {o.dtype} cap {o.capacity}: wpos {o._wpos} finished "
                  f"{o._finished} readers "
                  f"{[(r.pos, r.detached) for r in o._readers]}", file=err)
        elif isinstance(o, CircularWriter):
            lib = o._lib
            print(f"circular {o.dtype} cap {o.capacity}: wpos {lib.fsdr_ring_wpos(o._ring)} "
                  f"finished {o._finished} readers "
                  f"{[(lib.fsdr_ring_rpos(o._ring, r.idx), r.detached) for r in o._readers]}",
                  file=err)
    err.flush()
    os._exit(4)


def stress(dev, runs: int) -> None:
    """The streamed phases of the spectrum chain and the FM front end, each
    ``runs`` times after the resident phases (where a stall was once seen),
    each run under a ``STRESS_STALL_S`` watchdog."""
    import threading

    from futuresdr_tpu_torch.dsp import firdes
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    phase_resident(dev, taps)
    phase_fm_resident(dev)
    phases = (("spectrum streamed", lambda: phase_streamed(dev, taps)),
              ("fm streamed", lambda: phase_fm_streamed(dev)))
    t0 = time.perf_counter()
    for i in range(runs):
        for name, fn in phases:
            what = f"{name} run {i + 1}"
            faulthandler.dump_traceback_later(STRESS_STALL_S, exit=False)
            timer = threading.Timer(STRESS_STALL_S + 5, _stall_report, args=(what,))
            timer.daemon = True
            timer.start()
            try:
                fn()
            finally:
                timer.cancel()
                faulthandler.cancel_dump_traceback_later()
            print(f"stress: {what} passed ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"stress: {runs} runs of each streamed phase, no stall")


# ---------------------------------------------------------------------------
# phase 30: the device axis (training, the mesh, the sharded programs, the
# sharded engine, pipeline parallelism, checkpoints)
# ---------------------------------------------------------------------------

SH_SHARDS = 4                    # the mesh's width: logical shards on one card
SH_TRAIN_STEPS = 30
SH_TRAIN_BATCH = 128
SH_GRAD_TOL = 1e-3               # card against CPU, of each leaf's largest |g|
SH_SP_FRAME = 1 << 20            # sp_fir_fft_mag2_stream / sp_fir_stream frame
SH_SP_FRAMES = 3                 # chained frames of each stream check
SH_PFB_FRAME = 1 << 18
SH_DATA_FRAME = 1 << 18          # the fused spectrum chain's frame a shard
SH_FM_FRAME = 512_000            # the FM kernel chain's frame a shard
SH_DATA_K = (1, 4)
SH_GROUPS = 4                    # ShardRunner groups of the fault run
SH_SERVE_SESSIONS = 16
SH_SERVE_FRAMES = 3
SH_PP = (4, 8, 64, 256)          # stages, microbatches, rows, width of the pp check
SH_RATE_REPS = 5
SH_TOL = 1e-4                    # sharded stream against the one-device chain
SH_KERNELS = ("fir", "fir_fft", "rotator", "poly_fir", "quad_demod", "pfb")


class _Drive:
    """The hand kernels' launches of the sharded main path: each drive adds
    its own delta of ``cuda_kernels.launches``, so comparison launches made
    between drives count for nothing."""

    def __init__(self):
        self.counts = {}

    def __call__(self, fn, *args, **kw):
        import torch

        from futuresdr_tpu_torch.ops import cuda_kernels as ck
        before = dict(ck.launches)
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        for k, v in ck.launches.items():
            self.counts[k] = self.counts.get(k, 0) + v - before[k]
        return out


def _shard_devices():
    """The mesh's devices: the cards when there are enough, else
    ``SH_SHARDS`` logical devices on card 0 (config ``virtual_devices``)."""
    import torch

    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.parallel import visible_devices
    if torch.cuda.device_count() < SH_SHARDS:
        config().virtual_devices = SH_SHARDS
    return visible_devices()[:SH_SHARDS]


def phase_train(dev, card_line) -> dict:
    """30 (a): ``mcldnn_v1``'s widths trained for 30 steps at batch 128 on the
    card: finite loss that falls, the first step's gradients against the
    CPU's, ms a step."""
    import json as _json

    import torch

    from futuresdr_tpu_torch.models import modrec
    from futuresdr_tpu_torch.models.mcldnn import (MCLDNN, init_params, make_train_step,
                                                   trainable_parameters)
    with open(f"{modrec.WEIGHTS_DIR}/mcldnn_v1.json") as f:
        cfg = _json.load(f)
    widths = dict(n_classes=cfg["n_classes"], conv_features=cfg["conv_features"],
                  lstm_features=cfg["lstm_features"])
    n = cfg["n"]
    rng = np.random.default_rng(SEED + 300)
    batches = [modrec.synth_batch(rng, SH_TRAIN_BATCH, n) for _ in range(SH_TRAIN_STEPS)]
    grads = []
    for where in (dev, torch.device("cpu")):
        m = init_params(MCLDNN(**widths).to(where), torch.Generator().manual_seed(SEED))
        step = make_train_step(m, torch.optim.SGD(trainable_parameters(m), lr=0.0))
        X, y = batches[0]
        step(torch.from_numpy(X).to(where), torch.from_numpy(y).to(where))
        grads.append({k: p.grad.detach().cpu() for k, p in m.named_parameters()
                      if p.grad is not None})
    worst = max(float((grads[0][k] - g).abs().max() / g.abs().max())
                for k, g in grads[1].items())
    check(worst <= SH_GRAD_TOL, f"train: the card's first-step gradients are {worst:.3g} "
                                f"of a leaf's largest |g| from the CPU's (limit "
                                f"{SH_GRAD_TOL})")
    m = init_params(MCLDNN(**widths).to(dev), torch.Generator().manual_seed(SEED))
    step = make_train_step(m, torch.optim.Adam(trainable_parameters(m), lr=1e-3))
    data = [(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)) for X, y in batches]
    losses, times = [], []
    for X, y in data:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss, _acc = step(X, y)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first, f"train: the loss did not fall ({first:.4f} -> {last:.4f})")
    ms = statistics.median(times[5:])
    print(f"phase 30 (a) train mcldnn_v1 (conv {widths['conv_features']}, LSTM "
          f"{widths['lstm_features']}, {widths['n_classes']} classes, n {n}) batch "
          f"{SH_TRAIN_BATCH}: {ms:.3f} ms a step (median of steps 6-{SH_TRAIN_STEPS}), loss "
          f"{first:.4f} -> {last:.4f}, first-step gradients {worst:.3g} of a leaf's largest "
          f"|g| from the CPU's [{card_line}]")
    return {"ms": ms, "grad_err": worst, "loss": (first, last)}


def _mesh_note(devs) -> str:
    """What a rate's shards ran on; logical shards on one card measure the
    sharding's overhead, not its scaling."""
    from futuresdr_tpu_torch.parallel import describe_devices
    note = describe_devices(devs)
    return note + ("; overhead, not scaling" if "logical" in note else "")


def _timed(fn, reps: int = SH_RATE_REPS) -> float:
    """Median host seconds of ``fn()`` to the card's idle, after a warm call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_sp_streams(dev, devs, card_line, drive) -> dict:
    """30 (b): over the 4-shard mesh ``sp_fir_fft_mag2_stream`` at 2^20,
    ``sp_fir_stream``, ``sp_channelizer`` (PFB-64) at 2^18 and
    ``make_pp_pipeline``, each against its one-device chain and its kernels'
    plain versions; rates at D = 1 and D = 4."""
    import torch

    from futuresdr_tpu_torch.blocks.pfb import pfb_default_taps
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.parallel import (make_mesh, make_pp_pipeline, place,
                                              sp_channelizer, sp_fir_fft_mag2_stream,
                                              sp_fir_stream, to_host)
    from futuresdr_tpu_torch.parallel.stream_sp import _pfb_taps
    gen = torch.Generator(device=dev).manual_seed(SEED + 301)
    taps = np.hanning(N_TAPS).astype(np.float32)
    tt = torch.from_numpy(taps).to(dev)
    mesh = make_mesh(("sp",), shape=(SH_SHARDS,), devices=devs)
    mesh1 = make_mesh(("sp",), shape=(1,), devices=devs[:1])
    out, rates = {}, {}
    for name, make, one, plain in (
            ("sp_fir_fft_mag2_stream",
             lambda m: sp_fir_fft_mag2_stream(taps, N_FFT, m),
             lambda h, x: _mag2(ck.fir_fft(h, x, tt, N_FFT)),
             lambda h, x: _mag2(ck.fir_fft_plain(h, x, tt, N_FFT))),
            ("sp_fir_stream", lambda m: sp_fir_stream(taps, m),
             lambda h, x: ck.fir_continue(h, x, tt),
             lambda h, x: ck.fir_continue_plain(h, x, tt))):
        fn, init = make(mesh)
        carry = init(np.complex64)
        hist = torch.zeros(N_TAPS - 1, dtype=torch.complex64, device=dev)
        worst = worst_plain = 0.0
        mesh.reset_counts()
        for _ in range(SH_SP_FRAMES):
            x = randc(SH_SP_FRAME, gen, dev)
            carry, y = drive(fn, carry, x)
            got = torch.from_numpy(to_host(y))
            want, want_plain = one(hist, x).cpu(), plain(hist, x).cpu()
            hist = x[-(N_TAPS - 1):].clone()
            worst = max(worst, rel_err(got, want)[1])
            worst_plain = max(worst_plain, rel_err(got, want_plain)[1])
        check(worst <= SH_TOL and worst_plain <= SH_TOL,
              f"{name}: {worst:.3g} from the one-device chain, {worst_plain:.3g} from the "
              f"plain versions (limit {SH_TOL})")
        check(mesh.transfers["ppermute"] == SH_SP_FRAMES * SH_SHARDS,
              f"{name}: {dict(mesh.transfers)} transfers over {SH_SP_FRAMES} frames")
        for m, label in ((mesh1, 1), (mesh, SH_SHARDS)):
            f, ini = make(m)
            xs = place(randc(SH_SP_FRAME, gen, dev), m)
            st = {"c": ini(np.complex64)}

            def run(f=f, xs=xs, st=st):
                st["c"], _y = f(st["c"], xs)
            rates[(name, label)] = SH_SP_FRAME / _timed(run) / 1e6
        out[name] = {"err": worst, "err_plain": worst_plain}
    # the PFB-64 channelizer: the one-device pfb over the whole frame
    ptaps = pfb_default_taps(PFB_N)
    N, K, w = _pfb_taps(PFB_N, ptaps)
    wd = w.to(dev)
    x = randc(SH_PFB_FRAME, gen, dev)
    hist = torch.zeros((K - 1) * N, dtype=torch.complex64, device=dev)
    got = torch.from_numpy(to_host(drive(sp_channelizer(PFB_N, ptaps, mesh), x)))
    want = ck.pfb(hist, x, wd).t().cpu()
    want_plain = ck.pfb_plain(hist, x, wd).t().cpu()
    e1, e2 = rel_err(got, want)[1], rel_err(got, want_plain)[1]
    check(e1 <= SH_TOL and e2 <= SH_TOL, f"sp_channelizer: {e1:.3g} from one device, "
                                         f"{e2:.3g} from plain (limit {SH_TOL})")
    out["sp_channelizer"] = {"err": e1, "err_plain": e2}
    for m, label in ((mesh1, 1), (mesh, SH_SHARDS)):
        f = sp_channelizer(PFB_N, ptaps, m)
        xs = place(x, m)
        rates[("sp_channelizer", label)] = SH_PFB_FRAME / _timed(lambda: f(xs)) / 1e6
    # GPipe over the mesh as a pp axis, against the stages one after another
    S, M, rows, d = SH_PP
    pmesh = make_mesh(("pp",), shape=(S,), devices=devs)
    W = torch.randn(S, d, d, generator=gen, device=dev) / d ** 0.5
    xm = torch.randn(M, rows, d, generator=gen, device=dev)
    pfn = make_pp_pipeline(lambda a, b: torch.tanh(b @ a), S, M, pmesh)
    got = drive(pfn, W, xm)
    ref = xm
    for s in range(S):
        ref = torch.tanh(ref @ W[s])
    e = rel_err(got, ref)[1]
    check(e <= 1e-5, f"make_pp_pipeline: {e:.3g} from the sequential stages")
    out["make_pp_pipeline"] = {"err": e}
    rates[("make_pp_pipeline", S)] = M * rows / _timed(lambda: pfn(W, xm)) / 1e6
    for (name, label), r in sorted(rates.items()):
        unit = "Mrows/s" if name == "make_pp_pipeline" else "input Msamples/s"
        print(f"rate sharded {name} D={label} ({_mesh_note(devs[:label])}): {r:.4f} {unit} "
              f"[{card_line}]")
    print(f"phase 30 (b) errors: " + ", ".join(
        f"{k} {v['err']:.3g}" for k, v in out.items()))
    return {"errors": out, "rates": rates}


def _mag2(s):
    return s.real * s.real + s.imag * s.imag


def phase_data_shard(dev, devs, card_line, drive) -> dict:
    """30 (c): ``ShardedProgram`` over the fused spectrum chain (2^18, K = 1
    and 4) and the FM kernel chain (512,000): every row bit-equal to the
    D = 1 program, zero cross-shard transfers; a ``ShardRunner`` dispatch
    fault recovered bit-equal; rates at D = 1 and 4."""
    import torch

    from futuresdr_tpu_torch.ops.stages import Pipeline
    from futuresdr_tpu_torch.runtime import faults as _faults
    from futuresdr_tpu_torch.shard import (ShardRunner, ShardedProgram, collective_ops,
                                           plan_shard, rows_to_host)
    taps = firdes_lowpass()
    rng = np.random.default_rng(SEED + 302)
    chains = {"spectrum fused": (serve_main_pipe(taps), SH_DATA_FRAME, SH_DATA_K),
              "fm kernel": (Pipeline(fm_stages("kernel"), np.complex64), SH_FM_FRAME, (1,))}
    rates = {}
    for label, (pipe, frame, ks) in chains.items():
        prog = ShardedProgram(pipe, plan_shard(pipe, mode="data", n_devices=SH_SHARDS,
                                               device=dev), name=f"p30 {label}")
        for k in ks:
            shape = (SH_SHARDS, frame) if k == 1 else (SH_SHARDS, k, frame)
            x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
                 ).astype(np.complex64) * 0.5
            fn, carries = prog.compile(frame, k)
            carries, ys = drive(fn, carries, x)
            got = rows_to_host(ys)
            f1, _c = pipe.compile(frame, dev, k=k)
            for d in range(SH_SHARDS):
                _c1, y1 = f1(pipe.init_carry(dev), torch.from_numpy(x[d]).to(dev))
                check(np.array_equal(y1.cpu().numpy(), got[d]),
                      f"data shard {label} K={k}: row {d} differs from the D = 1 program")
            check(collective_ops(prog) == [], f"data shard {label}: cross-shard transfers "
                                              f"{dict(prog.mesh.transfers)}")
            # both rates host rows in and host rows out, as ShardRunner runs
            st = {"c": pipe.init_carry(dev), "cs": carries}

            def one(st=st, f1=f1, x0=x[0]):
                st["c"], y = f1(st["c"], torch.from_numpy(x0).to(dev))
                y.cpu()

            def many(st=st, fn=fn, x=x):
                st["cs"], ys = fn(st["cs"], x)
                rows_to_host(ys)
            rates[(label, k, 1)] = frame * k / _timed(one) / 1e6
            rates[(label, k, SH_SHARDS)] = SH_SHARDS * frame * k / _timed(many) / 1e6
    # ShardRunner: a dispatch fault, recover(), bit-equal to an unfailed run
    pipe = serve_main_pipe(taps)
    groups = [(rng.standard_normal((SH_SHARDS, 4, SH_DATA_FRAME)) + 0j).astype(np.complex64)
              for _ in range(SH_GROUPS)]

    def runner(name, every):
        p = ShardedProgram(pipe, plan_shard(pipe, mode="data", n_devices=SH_SHARDS,
                                            device=dev), name=name)
        return ShardRunner(p, SH_DATA_FRAME, k=4, checkpoint_every=every, name=name)
    ref_r = runner("p30ref", 1)
    ref = [drive(ref_r.run_group, g) for g in groups]
    hit = runner("p30hit", 2)
    out = [drive(hit.run_group, g) for g in groups[:3]]
    _faults.arm("dispatch:p30hit", rate=1.0, seed=SEED, max_faults=1)
    try:
        try:
            hit.run_group(groups[3])
            check(False, "ShardRunner: the armed dispatch fault did not fire")
        except _faults.InjectedFault:
            replayed = drive(hit.recover)
    finally:
        _faults.disarm()
    out.append(drive(hit.run_group, groups[3]))
    check(replayed == 1 and all(np.array_equal(a, b) for a, b in zip(ref, out)),
          f"ShardRunner: recovered run differs from the unfailed one (replayed {replayed})")
    for (label, k, D), r in sorted(rates.items()):
        print(f"rate sharded data {label} frame={chains[label][1]} K={k} D={D} "
              f"({_mesh_note(devs[:D])}): {r:.1f} input Msamples/s [{card_line}]")
    return {"rates": rates, "replayed": replayed}


def firdes_lowpass():
    from futuresdr_tpu_torch.dsp import firdes
    return firdes.lowpass(0.2, N_TAPS).astype(np.float32)


def phase_sharded_serving(dev, devs, card_line, drive) -> dict:
    """30 (d): ``ServeEngine(shard_devices=4)`` on the main served chain, 16
    sessions × 2^18: every session's stream bit-equal to the unsharded
    engine's (an evict and readmit included); the served rates."""
    import torch

    from futuresdr_tpu_torch.serve import ServeEngine
    pipe = serve_main_pipe(firdes_lowpass())
    gen = torch.Generator(device=dev).manual_seed(SEED + 303)
    data = [[randc(SERVE_FRAME, gen, dev).cpu().numpy() for _ in range(SH_SERVE_FRAMES)]
            for _ in range(SH_SERVE_SESSIONS)]
    outs, rates = {}, {}
    for shard in (SH_SHARDS, 0):
        eng = ServeEngine(pipe, frame_size=SERVE_FRAME, app=f"p30serve{shard}",
                          buckets=(SH_SERVE_SESSIONS,), shard_devices=shard, device=dev)
        sids = [eng.admit(tenant=f"t{i % 4}").sid for i in range(SH_SERVE_SESSIONS)]
        got = {s: [] for s in sids}

        def serve_all(step_frames):
            for j in step_frames:
                for s, d in zip(sids, data):
                    eng.submit(s, d[j])
                eng.step()
            while eng.step():
                pass
        d_fn = drive if shard else (lambda f, *a: f(*a))
        d_fn(serve_all, [0])
        eng.evict(sids[3])
        eng.readmit(sids[3])
        d_fn(serve_all, range(1, SH_SERVE_FRAMES))
        for s in sids:
            got[s] = eng.results(s)
        outs[shard] = list(got.values())
        dt = _timed(lambda: serve_all([0]), reps=3)
        rates[shard] = SH_SERVE_SESSIONS * SERVE_FRAME / dt / 1e6
        if shard:
            desc = eng.describe()["shard"]
            check(desc == {"devices": SH_SHARDS, "sharded": True,
                           "lanes_per_device": SH_SERVE_SESSIONS // SH_SHARDS},
                  f"sharded engine: {desc}")
    for a, b in zip(outs[SH_SHARDS], outs[0]):
        check(len(a) == len(b) == SH_SERVE_FRAMES and all(np.array_equal(u, v)
                                                          for u, v in zip(a, b)),
              "sharded engine: a session's stream differs from the unsharded engine's")
    for shard, r in rates.items():
        print(f"rate served main chain {SH_SERVE_SESSIONS} x {SERVE_FRAME} shard_devices="
              f"{shard} ({_mesh_note(devs[:max(shard, 1)])}): {r:.1f} input Msamples/s "
              f"[{card_line}]")
    return {"rates": rates}


def phase_composed(dev, devs, drive) -> None:
    """30 (e): SpKernel along sp and PpKernel along pp in one flowgraph over a
    (2, 2) mesh, interrupted, its state saved and restored into fresh blocks:
    the resumed run equals the whole one."""
    import tempfile

    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.parallel import make_mesh, sp_fir_stream
    from futuresdr_tpu_torch.tpu import PpKernel, SpKernel
    from futuresdr_tpu_torch.utils.checkpoint import (load_flowgraph_state,
                                                      save_flowgraph_state)
    mesh = make_mesh(("pp", "sp"), shape=(2, 2), devices=devs)
    d, mb, F = 64, 16, 1 << 16
    rng = np.random.default_rng(SEED + 304)
    W = (rng.standard_normal((2, d, d)) / 8).astype(np.float32)
    data = rng.standard_normal(4 * F).astype(np.float32)
    taps = np.hanning(32).astype(np.float32)

    def build(n, off=0):
        fn, init = sp_fir_stream(taps, mesh)
        fg, snk = Flowgraph(), VectorSink(np.float32)
        fg.connect(VectorSource(data[off:off + n * F]),
                   SpKernel(fn, mesh, np.float32, np.float32, F, init_carry=init),
                   PpKernel(lambda w, a: torch.tanh(a @ w), W, mesh, np.float32, np.float32,
                            micro_shape=(mb, d), n_micro=F // (mb * d), wire="f32",
                            frames_in_flight=1), snk)
        return fg, snk
    fg, snk = build(4)
    drive(Runtime().run, fg)
    full = np.asarray(snk.items())
    fg_b, snk_b = build(2)
    drive(Runtime().run, fg_b)
    with tempfile.TemporaryDirectory() as tmp:
        save_flowgraph_state(fg_b, f"{tmp}/state")
        fg_c, snk_c = build(2, 2 * F)
        check(load_flowgraph_state(fg_c, f"{tmp}/state") == 1, "composed: no state loaded")
    drive(Runtime().run, fg_c)
    resumed = np.concatenate([np.asarray(snk_b.items()), np.asarray(snk_c.items())])
    check(full.shape == (4 * F,) and np.array_equal(resumed, full),
          "composed (pp, sp): the resumed run differs from the whole one")
    print(f"phase 30 (e) composed (pp, sp) over {len(devs)} shard(s): {4 * F} samples, "
          f"resumed equals full")


def phase_autotune_shard(dev, card_line) -> dict:
    """30 (f): ``autotune_shard`` over the widths there are."""
    from futuresdr_tpu_torch.tpu import TpuInstance
    from futuresdr_tpu_torch.tpu.autotune import autotune_shard, cached_shard_devices
    pipe = serve_main_pipe(firdes_lowpass())
    inst = TpuInstance(dev)
    best, rates = autotune_shard(pipe, pipe.in_dtype, frame=SH_DATA_FRAME,
                                 devices=(1, 2, SH_SHARDS), min_seconds=0.2, inst=inst)
    from futuresdr_tpu_torch.tpu.autotune import platform_of
    check(cached_shard_devices(pipe.stages, pipe.in_dtype, platform_of(inst)) == best,
          "autotune_shard: the pick was not recorded")
    check(set(rates) == {1, 2, SH_SHARDS}, f"autotune_shard measured {sorted(rates)}")
    print(f"phase 30 (f) autotune_shard: best D={best}, " + ", ".join(
        f"D={k} {v:.1f} Msamples/s" for k, v in sorted(rates.items())) + f" [{card_line}]")
    return {"best": best, "rates": rates}


def phase_sharded(dev, card_line) -> dict:
    """Phase 30, the device axis: (a) training, (b) the sequence-parallel
    streams and GPipe, (c) the data-sharded programs and ``ShardRunner``, (d)
    the sharded engine, (e) the composed (pp, sp) flowgraph with a
    checkpoint, (f) ``autotune_shard``. The kernels' launches are counted
    over the sharded drives alone."""
    import torch

    from futuresdr_tpu_torch.parallel import describe_devices
    t0 = time.perf_counter()
    devs = _shard_devices()
    print(f"mesh: {describe_devices(devs)}")
    drive = _Drive()
    train = phase_train(dev, card_line)
    sp = phase_sp_streams(dev, devs, card_line, drive)
    data = phase_data_shard(dev, devs, card_line, drive)
    serving = phase_sharded_serving(dev, devs, card_line, drive)
    phase_composed(dev, devs, drive)
    tune = phase_autotune_shard(dev, card_line)
    for k in SH_KERNELS:
        check(drive.counts.get(k, 0) > 0, f"kernel {k} was launched no time on the sharded "
                                          f"paths of phase 30")
    torch.cuda.synchronize()
    print(f"phase 30: {time.perf_counter() - t0:.1f} s, launches "
          + ", ".join(f"{k} {v}" for k, v in sorted(drive.counts.items()) if v))
    return {"launches": drive.counts, "train": train, "sp": sp, "data": data,
            "serving": serving, "tune": tune}


# ---------------------------------------------------------------------------
# phase 31: the telemetry plane on the card
# ---------------------------------------------------------------------------

TELE_FRAME = 1 << 18           # the fused spectrum chain's streamed frame
TELE_FRAMES = 32               # frames of each streamed run (K = 1 and 4 divide it)
TELE_K = (1, 4)
TELE_RESIDENT_CALLS = 200      # calls of the resident program inside its gauge window
TELE_AB_STEPS = 60             # frame times of the served runs
TELE_GATE = 0.03               # the disabled hooks' share of the streamed run, at most
TELE_LANES = ("encode", "H2D", "compute", "D2H", "decode")
TELE_GAUGE_MAX = 1.05
#: the hand kernels phase 31 drives: the fused chain's, the resident
#: program's and serve_ab's lane forms
TELE_KERNELS = ("fir_fft", "fir", "rotator", "fir_lanes", "rotator_lanes")


def _tele_reasons(program: str) -> dict:
    from futuresdr_tpu_torch.telemetry import profile
    return {lab["reason"]: int(v) for lab, v in profile.COMPILES.samples()
            if lab["program"] == program}


def _tele_gauges(program: str) -> tuple:
    from futuresdr_tpu_torch.telemetry import profile
    return (profile.MFU.get(program=program), profile.HBM_UTIL.get(program=program))


def _tele_check_gauges(program: str, card_line: str) -> tuple:
    mfu, hbm = _tele_gauges(program)
    print(f"phase 31 (b): {program}: fsdr_mfu {mfu:.6g}, fsdr_hbm_util {hbm:.6g} "
          f"[{card_line}]")
    check(0 < mfu <= TELE_GAUGE_MAX and 0 < hbm <= TELE_GAUGE_MAX,
          f"{program}: fsdr_mfu {mfu} or fsdr_hbm_util {hbm} outside (0, {TELE_GAUGE_MAX}]")
    return mfu, hbm


def _tele_stream(dev, taps, k: int, data, name: str, window: bool = False):
    """``VectorSource -> TpuKernel(fused spectrum chain, K) -> VectorSink``;
    with ``window``, the profile plane's gauge window is seeded right after
    the init barrier and read at the end. Returns ``(output, kernel,
    elapsed s, work calls)``."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.telemetry import profile
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    kern = TpuKernel(chain_stages("fused", taps), np.complex64, frame_size=TELE_FRAME,
                     inst=TpuInstance(dev), frames_in_flight=IN_FLIGHT,
                     frames_per_dispatch=k, wire=LINK)
    kern.meta.instance_name = name
    fg = Flowgraph()
    snk = VectorSink(kern.pipeline.out_dtype)
    fg.connect(VectorSource(data), kern, snk)
    rt = Runtime()
    t0 = time.perf_counter()
    running = rt.start(fg)
    if window:
        plane = profile.plane()
        plane.program(name).ensure_cost()
        plane.update_live_gauges(min_interval=0.0)     # the window's left edge
    done = running.wait_sync()
    elapsed = time.perf_counter() - t0
    rt.shutdown()
    if window:
        torch.cuda.synchronize()
        profile.plane().update_live_gauges(min_interval=0.0)
    calls = sum(b.work_calls for b in done._blocks if b is not None)
    return np.asarray(snk.items()), kern, elapsed, calls


def _tele_hook_costs(n: int = 100_000) -> dict:
    """Per-call host cost (ns) of each disabled hook class on this host,
    micro-measured as ``tests/test_torch_telemetry.py`` does: the block
    loop's work call and park, the checkpoint and fleet guards, and the
    streamed kernel's per-frame and per-group hooks."""
    from futuresdr_tpu_torch.telemetry import doctor, fleet, lineage, profile, spans
    from futuresdr_tpu_torch.tpu.kernel_block import _stamp_metas
    rec = spans.recorder()
    check(not rec.enabled and fleet._tick_state is None,
          "the disabled gate needs tracing and the fleet off")
    hist = doctor.WORK_DURATION.labels(block="tele-gate-probe")
    e2e = doctor.E2E_LATENCY.labels(source="tele-gate-probe")
    entry = profile.register("tele-gate-probe")
    entry.dispatch()
    ltr = lineage.reset_tracer()
    sample = ltr.sample
    metas = ((TELE_FRAME, (), 0, 0),)
    ckpt_every = 0

    def best(loop):
        out = float("inf")
        for _ in range(3):
            t0 = time.perf_counter_ns()
            loop()
            out = min(out, (time.perf_counter_ns() - t0) / n)
        return out

    def work():
        tick = 0
        for _ in range(n):
            end = time.perf_counter_ns()
            tick += 1
            if not tick & 7:
                hist.observe(1.5e-6)
            if rec.enabled:
                rec.complete("block", "x", end)

    def park_ckpt_fleet():
        for i in range(n):
            if rec.enabled:
                rec.complete("park", "x", 0)
            if ckpt_every and (i + 1) % ckpt_every == 0:
                pass
            if fleet._tick_state is not None:
                fleet.tick()

    def frame():
        for _ in range(n):
            t_in = time.perf_counter_ns()
            tid = sample()
            if tid:
                ltr.finish(tid)
            if rec.enabled:
                rec.complete("tpu", "encode", 0)
            for lane in ("encode", "H2D", "dispatch", "D2H", "decode"):
                _stamp_metas(metas, lane)
            e2e.observe((time.perf_counter_ns() - t_in) * 1e-9)

    def group():
        for _ in range(n):
            for _s in range(3):
                if rec.enabled:
                    rec.complete("tpu", "compute", 0)
            entry.dispatch(t=time.monotonic())

    out = {"call": best(work) + best(park_ckpt_fleet), "frame": best(frame),
           "group": best(group)}
    ltr.clear()
    return out


def _tele_serve(dev, data, app: str, seed_window: bool):
    """serve_ab's chain at ``AB_SESSIONS`` lanes of ``AB_FRAME``: one frame a
    session every frame time for ``TELE_AB_STEPS`` steps, then drained.
    Returns ``(outputs a session, engine, step() wall times)``."""
    import torch

    from futuresdr_tpu_torch.serve import ServeEngine
    from futuresdr_tpu_torch.telemetry import profile
    eng = ServeEngine(serve_ab_pipe(), frame_size=AB_FRAME, app=app,
                      buckets=(AB_SESSIONS,), queue_frames=4, device=dev)
    sess = [eng.admit(tenant=f"t{i % 4}", sid=f"{app}{i}") for i in range(AB_SESSIONS)]
    outs = [[] for _ in sess]
    walls = []
    for j in range(TELE_AB_STEPS):
        for i, s in enumerate(sess):
            check(eng.submit(s.sid, data[i][j]), f"{app}: a submit was refused")
        t0 = time.perf_counter()
        eng.step()
        walls.append(time.perf_counter() - t0)
        if j == 0 and seed_window:
            torch.cuda.synchronize()
            plane = profile.plane()
            plane.program(f"serve:{app}").ensure_cost()
            plane.update_live_gauges(min_interval=0.0)
        for i, s in enumerate(sess):
            outs[i] += eng.results(s.sid)
    while eng.step():
        pass
    for i, s in enumerate(sess):
        outs[i] += eng.results(s.sid)
    torch.cuda.synchronize()
    if seed_window:
        profile.plane().update_live_gauges(min_interval=0.0)
    return outs, eng, walls


def _tele_get(url: str, timeout: float = 30.0):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _tele_post(url: str, body: dict):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _tele_gated_source(items, gate):
    """A source that emits ``items[:gate_at]``, then parks on an awaitable
    (no work call, so no progress) until ``gate[1]`` is set, then emits the
    rest. ``gate = (index, threading.Event)``."""
    import asyncio

    from futuresdr_tpu_torch import Kernel
    at, ev = gate

    class GatedSource(Kernel):
        def __init__(self):
            super().__init__()
            self.pos = 0
            self.output = self.add_stream_output("out", items.dtype)

        async def _wait_gate(self):
            while not ev.is_set():
                await asyncio.sleep(0.01)

        async def work(self, io, mio, meta):
            end = len(items) if ev.is_set() else at
            if self.pos >= end:
                io.block_on(self._wait_gate())
                return
            out = self.output.slice()
            n = min(len(out), end - self.pos)
            out[:n] = items[self.pos:self.pos + n]
            self.output.produce(n)
            self.pos += n
            if self.pos == len(items):
                io.finished = True
            elif n:
                io.call_again = True

    return GatedSource()


def _tele_live(dev, taps, card_line) -> dict:
    """(d) and (e): a streamed run held live by a gated source while every
    new route of the control port answers, the doctor's watchdog trips on
    the stall and names the source, and a capture in progress reads
    ``compiling``."""
    import socket
    import threading

    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import NullSink
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.ops.stages import Pipeline, Stage
    from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort
    from futuresdr_tpu_torch.serve import ServeEngine, register_app, unregister_app
    from futuresdr_tpu_torch.telemetry import doctor, fleet, profile
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = config()
    saved = (cfg.fleet_peers, cfg.fleet_poll_interval)
    cfg.fleet_peers, cfg.fleet_poll_interval = f"127.0.0.1:{port}", 0.2
    gen = torch.Generator(device=dev).manual_seed(SEED + 131)
    items = randc(8 * TELE_FRAME, gen, dev).cpu().numpy()
    gate = (4 * TELE_FRAME, threading.Event())
    d = doctor.doctor()
    d.enable(interval=0.05, window=3)
    route_eng = ServeEngine(serve_ab_pipe(), frame_size=AB_FRAME, app="tele_route",
                            buckets=(1,), device=dev)
    register_app(route_eng)
    rt = Runtime()
    cp = ControlPort(rt.handle, bind=f"127.0.0.1:{port}")
    answered = {}
    try:
        cp.start()
        src = _tele_gated_source(items, gate)
        src.meta.instance_name = "tele_gated_src"
        kern = TpuKernel(chain_stages("fused", taps), np.complex64, frame_size=TELE_FRAME,
                         inst=TpuInstance(dev), frames_in_flight=IN_FLIGHT, wire=LINK)
        kern.meta.instance_name = "tele_live"
        fg = Flowgraph()
        snk = NullSink(kern.pipeline.out_dtype)
        fg.connect(src, kern, snk)
        running = rt.start(fg)
        fg_id = rt.handle.flowgraph_ids()[-1]
        # (e) the watchdog trips on the stalled source and names it
        t0 = time.monotonic()
        while (d.last_trip or {}).get("state") != "starved" and time.monotonic() - t0 < 30:
            time.sleep(0.05)
        trip = d.last_trip or {}
        check(trip.get("state") == "starved" and trip.get("suspect_block") == "tele_gated_src",
              f"phase 31 (e): the watchdog read {trip.get('state')} naming "
              f"{trip.get('suspect_block')}, want starved naming tele_gated_src")
        rec = d.last_report or {}
        named = [fgr for fgr in (rec.get("flowgraphs") or {}).values()
                 if (fgr.get("diagnosis") or {}).get("suspect_block") == "tele_gated_src"]
        check(named and "tele_gated_src" in named[0]["blocks"],
              "phase 31 (e): the flight record does not name the stalled block")
        print(f"phase 31 (e): the watchdog tripped {trip['state']} after "
              f"{trip['no_progress_for_s']} s of no progress, suspect {trip['suspect_block']}; "
              f"the flight record carries {len(rec['threads'])} thread stacks")
        # a capture in progress reads "compiling", not a deadlock: a stage
        # whose fn holds the host 0.5 s runs in the warm-up and the capture
        att = next(a for a in d._fgs.values()
                   if any(b.instance_name == "tele_gated_src" for b in a.blocks))

        def slow(c, x):
            time.sleep(0.5)
            return c, x.clone()

        slow_pipe = Pipeline([Stage(fn=slow, init_carry=lambda dt, dv: torch.zeros(1, device=dv),
                                    name="slow")], np.complex64)
        cap = threading.Thread(target=slow_pipe.compile, args=(4096, dev),
                               kwargs={"program": "tele_capture"})
        cap.start()
        t0 = time.monotonic()
        while not profile.plane().active_compiles() and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        diag = d.diagnose(att)
        cap.join()
        check(diag["state"] == "compiling" and diag["suspect_block"] == "tele_capture"
              and "in progress" in diag["detail"],
              f"phase 31 (e): a capture in progress read {diag['state']} "
              f"({diag.get('detail')})")
        check(_tele_reasons("tele_capture") == {"warmup": 1},
              f"tele_capture compiles {_tele_reasons('tele_capture')}")
        print(f"phase 31 (e): during a capture the watchdog reads {diag['state']}: "
              f"{diag['detail']}")
        # (d) every new route answers during the live run
        base = cp.url
        t0 = time.monotonic()
        while time.monotonic() - t0 < 20:
            st, _ct, body = _tele_get(f"{base}/api/fleet/")
            if json.loads(body).get("hosts_ready"):
                break
            time.sleep(0.1)
        for path in (f"/api/fg/{fg_id}/trace/?keep=1", f"/api/fg/{fg_id}/doctor/",
                     f"/api/fg/{fg_id}/profile/", f"/api/fg/{fg_id}/lineage/?n=4",
                     "/api/events/?since=0", "/api/host/", "/api/fleet/"):
            st, ct, body = _tele_get(base + path)
            check(st == 200 and ct.startswith("application/json"),
                  f"phase 31 (d): {path} answered {st} {ct}")
            json.loads(body)
            answered[path] = len(body)
        st, ct, body = _tele_get(f"{base}/api/fleet/metrics")
        check(st == 200 and b"host=" in body, f"phase 31 (d): /api/fleet/metrics {st}")
        answered["/api/fleet/metrics"] = len(body)
        st, ct, body = _tele_post(f"{base}/api/fleet/serve/tele_route/session/",
                                  {"tenant": "t"})
        check(st == 201 and json.loads(body)["host"] == f"127.0.0.1:{port}",
              f"phase 31 (d): the routed admission answered {st}")
        answered["POST /api/fleet/serve/tele_route/session/"] = len(body)
        st, ct, body = _tele_get(f"{base}/metrics")
        check(b"fsdr_block_work_calls_total{block=\"tele_live\"" in body,
              "phase 31 (d): /metrics lacks the per-block families")
        print("phase 31 (d): every new route answered 200/201 during the live run: " +
              ", ".join(f"{p} ({n} B)" for p, n in answered.items()))
        gate[1].set()
        running.wait_sync()
    finally:
        gate[1].set()
        d.disable()
        d.last_trip = None
        cp.stop()
        fleet.shutdown()
        cfg.fleet_peers, cfg.fleet_poll_interval = saved
        unregister_app("tele_route")
        route_eng.shutdown()
        rt.shutdown()
    return answered


def phase_telemetry(dev, taps, card_line) -> dict:
    """Phase 31, the telemetry plane on the card (see the module docstring).
    Returns the printed figures."""
    import statistics as st

    import torch

    from futuresdr_tpu_torch.ops.stages import (Pipeline, fft_stage, fir_stage, mag2_stage,
                                                rotator_stage)
    from futuresdr_tpu_torch.telemetry import lineage, profile, spans
    check(not spans.enabled(), "phase 31 needs tracing off at its start")
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    data = randc(TELE_FRAMES * TELE_FRAME, gen, dev).cpu().numpy()
    rec = spans.recorder()
    # (a) the streamed path, tracing off then on, K = 1 and 4
    for k in TELE_K:
        off, kern_off, el_off, calls_off = _tele_stream(dev, taps, k, data, f"tele_off_k{k}",
                                                        window=True)
        rec.drain()
        spans.enable(True)
        try:
            on, kern, _el, _calls = _tele_stream(dev, taps, k, data, f"tele_fused_k{k}")
        finally:
            spans.enable(False)
        evs = rec.drain()
        check(np.array_equal(on, off), f"phase 31 (a): K={k} traced output differs from "
                                       f"untraced")
        groups = kern.dispatches
        check(groups == TELE_FRAMES // k, f"phase 31 (a): {groups} groups at K={k}")
        lanes = {n: [e for e in evs if e.cat == "tpu" and e.name == n] for n in TELE_LANES}
        want = {"encode": TELE_FRAMES, "H2D": groups, "compute": groups, "D2H": groups,
                "decode": groups}
        got = {n: len(v) for n, v in lanes.items()}
        check(got == want, f"phase 31 (a): K={k} spans {got}, want {want}")
        trace = spans.chrome_trace(evs)
        path = _build_dir().parent / f"telemetry_trace_k{k}.json"
        path.write_text(json.dumps(trace))
        parsed = json.loads(path.read_text())
        check(len([e for e in parsed["traceEvents"] if e["ph"] == "X"]) >= sum(got.values()),
              "phase 31 (a): the exported trace lost spans")
        per_frame = {n: st.median(e.dur_ns for e in v) / 1e3 / (1 if n == "encode" else k)
                     for n, v in lanes.items()}
        ov = spans.overlap_report(evs, names=TELE_LANES)
        out[("split", k)] = per_frame
        print(f"phase 31 (a): fused 2^18 K={k}: traced output bit-equal to untraced; "
              f"{groups} groups each with encode, H2D, compute, D2H and decode spans; "
              f"trace {path.name} ({len(parsed['traceEvents'])} events) parsed; median "
              f"host us a frame: " + ", ".join(f"{n} {v:.1f}" for n, v in per_frame.items())
              + f"; lanes' union/sum {ov['ratio']:.3f} [{card_line}]")
        # (b) the streamed program on the profile plane
        entry = profile.plane().program(f"tele_off_k{k}")
        check(entry.units == kern_off.dispatches, f"phase 31 (b): {entry.units} units for "
                                                  f"{kern_off.dispatches} dispatches")
        check(_tele_reasons(f"tele_off_k{k}") == {"warmup": 1},
              f"phase 31 (b): compiles {_tele_reasons(f'tele_off_k{k}')}")
        out[("stream_gauges", k)] = _tele_check_gauges(f"tele_off_k{k}", card_line)
        out[("stream_run", k)] = (el_off, calls_off, kern_off.frames_dispatched,
                                  kern_off.dispatches)
    # (b) a resident Pipeline.compile, and a recapture for a changed carry
    pipe = Pipeline([rotator_stage(0.013, impl="pallas"), fir_stage(taps, impl="pallas"),
                     fft_stage(N_FFT), mag2_stage()], np.complex64)
    fn, carry = pipe.compile(TELE_FRAME, dev, program="tele_resident")
    check(_tele_reasons("tele_resident") == {"warmup": 1},
          f"phase 31 (b): resident compiles {_tele_reasons('tele_resident')}")
    x = randc(TELE_FRAME, gen, dev)
    carry, _y = fn(carry, x)
    torch.cuda.synchronize()
    plane = profile.plane()
    plane.program("tele_resident").ensure_cost()
    plane.update_live_gauges(min_interval=0.0)
    for _ in range(TELE_RESIDENT_CALLS):
        carry, _y = fn(carry, x)
    torch.cuda.synchronize()
    plane.update_live_gauges(min_interval=0.0)
    out["resident_gauges"] = _tele_check_gauges("tele_resident", card_line)
    os_pipe = Pipeline([fir_stage(np.ones(16, np.float32) / 16, fft_len=1024)], np.complex64)
    ofn, oc = os_pipe.compile(4 * os_pipe.frame_multiple, dev, program="tele_recapture")
    frame = randc(4 * os_pipe.frame_multiple, gen, dev)
    oc, _ = ofn(oc, frame)
    (H, _tt, tail), = oc
    oc, _ = ofn(((H, torch.zeros(32, device=dev), tail),), frame)
    reasons = _tele_reasons("tele_recapture")
    sigs = [r[3] for r in plane._recent if r[1] == "tele_recapture"]
    check(reasons == {"warmup": 1, "reinit": 1} and ofn.captures == 2
          and sigs[-1].startswith("carry:"),
          f"phase 31 (b): a changed carry shape billed {reasons} ({sigs})")
    print(f"phase 31 (b): compiles by reason: tele_off_k1 {_tele_reasons('tele_off_k1')}, "
          f"tele_resident {_tele_reasons('tele_resident')}, tele_recapture {reasons} "
          f"({sigs[-1]}); compiles_total {plane.compiles_total}")
    # (c) serving: serve_ab's chain, tracing off then on
    rng = np.random.default_rng(SEED + 32)
    sdata = [[(rng.standard_normal(AB_FRAME) + 1j * rng.standard_normal(AB_FRAME))
              .astype(np.complex64) for _ in range(TELE_AB_STEPS)] for _ in range(AB_SESSIONS)]
    s_off, e_off, walls_off = _tele_serve(dev, sdata, "tele_ab_off", True)
    rec.drain()
    spans.enable(True)
    try:
        s_on, e_on, walls_on = _tele_serve(dev, sdata, "tele_ab", False)
    finally:
        spans.enable(False)
    sevs = rec.drain()
    for i in range(AB_SESSIONS):
        check(len(s_on[i]) == len(s_off[i]) == TELE_AB_STEPS and all(
            np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(s_on[i], s_off[i])),
            f"phase 31 (c): session {i} traced differs from untraced")
    steps = [e for e in sevs if e.cat == "serve" and e.name == "serve_step"]
    check(len(steps) == e_on.dispatches == TELE_AB_STEPS,
          f"phase 31 (c): {len(steps)} serve_step spans, {e_on.dispatches} dispatches")
    p50, p99 = (e_on.e2e_hist.quantile(q) for q in (0.5, 0.99))
    prof_us = {n: st.median(e.dur_ns for e in sevs if e.cat == "tpu" and e.name == n) / 1e3
               for n in TELE_LANES}
    prof_us["serve_step"] = st.median(e.dur_ns for e in steps) / 1e3
    prof_us["step() wall"] = st.median(walls_off[1:]) * 1e6
    out["serve"] = {"p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3, "profile_us": prof_us}
    out["serve_gauges"] = _tele_check_gauges("serve:tele_ab_off", card_line)
    print(f"phase 31 (c): serve_ab {AB_SESSIONS} x {AB_FRAME}, {TELE_AB_STEPS} steps: "
          f"traced bit-equal to untraced, {len(steps)} serve_step spans; E2E_LATENCY "
          f"p50 {p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms; ServeEngine.step host profile, "
          f"median us: " + ", ".join(f"{n} {v:.1f}" for n, v in prof_us.items())
          + f" [{card_line}]")
    e_on.shutdown()
    e_off.shutdown()
    # (d), (e) the control port and the doctor during a live run
    out["routes"] = _tele_live(dev, taps, card_line)
    # (f) the disabled hooks' cost on the streamed path, by the analytic gate
    costs = _tele_hook_costs()
    el, calls, frames, groups = out[("stream_run", 1)]
    share = (calls * costs["call"] + frames * costs["frame"] + groups * costs["group"]) \
        * 1e-9 / el
    out["disabled"] = (share, costs, el, calls, frames, groups)
    print(f"phase 31 (f): disabled hooks {share * 100:.3f}% of the streamed fused 2^18 K=1 "
          f"run ({calls} work calls x {costs['call']:.0f} ns, {frames} frames x "
          f"{costs['frame']:.0f} ns, {groups} groups x {costs['group']:.0f} ns over "
          f"{el * 1e3:.1f} ms) [{card_line}]")
    check(share <= TELE_GATE, f"phase 31 (f): the disabled hooks cost {share * 100:.2f}%, "
                              f"over {TELE_GATE * 100:.0f}%")
    lineage.reset_tracer()
    return out


# ---------------------------------------------------------------------------
# phase 32: the mesh across processes, the sharded train step, the entry
# points and LoRa
# ---------------------------------------------------------------------------

MH_RANKS = 2
MH_LOGICAL = 2                 # logical devices a rank in (a): a global mesh of 4
MH_FRAME = 1 << 21             # (a)'s complex64 frame, the main chain's width
MH_STREAM_FRAMES = 4
MH_REPS = 20                   # timed frames of (a)
MH_TOL = 1e-5                  # (a) against the fir kernel's plain version, of peak
MH_TRAIN_BATCH = 128
MH_TRAIN_STEPS = 10
MH_STEP_TOL = 2e-6             # tests/test_torch_train.py's STEP_TOL
MH_TINY_G = 1e-6               # ... and the |g| below which a step's sign is noise
MH_ENTRY_TOL = 1e-5            # entry()'s logits on the card against the CPU, of peak
MH_DRYRUN_DEVICES = 4
MH_RANK_TIMEOUT_S = 400
MH_KERNELS = ("fir", "fir_fft", "pfb")
LORA_LOOPBACK_FRAMES = {7: 16, 12: 8}
LORA_SCAN_SF = 12
LORA_SCAN_FRAMES = 16
LORA_SCAN_SNR_DB = 25.0
LORA_SCAN_TOL = 1e-5
LORA_SCAN_REPS = 5


def _mh_frames():
    """(a)'s inputs, the same on every rank: ``MH_STREAM_FRAMES`` seeded
    complex64 frames (the first is the frame of the one-shot ``sp_fir``)."""
    rng = np.random.default_rng(SEED + 320)
    return [(rng.standard_normal(MH_FRAME) + 1j * rng.standard_normal(MH_FRAME))
            .astype(np.complex64) for _ in range(MH_STREAM_FRAMES)]


def _mh_batches(n: int):
    from futuresdr_tpu_torch.models import modrec
    rng = np.random.default_rng(SEED + 321)
    return [modrec.synth_batch(rng, MH_TRAIN_BATCH, n) for _ in range(MH_TRAIN_STEPS)]


def _mcldnn_v1():
    import json as _json

    from futuresdr_tpu_torch.models import modrec
    with open(f"{modrec.WEIGHTS_DIR}/mcldnn_v1.json") as f:
        cfg = _json.load(f)
    return {k: cfg[k] for k in ("n_classes", "conv_features", "lstm_features")}, cfg["n"]


def _peak_err(got, want) -> tuple:
    """``(max |got - want|, max |want|)`` of two host arrays, in float64."""
    g = np.asarray(got).astype(np.complex128)
    w = np.asarray(want).astype(np.complex128)
    return float(np.abs(g - w).max()), float(np.abs(w).max())


def _sha(a: np.ndarray) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def rank_process(rank: int, coordinator: str, out_dir: str) -> int:
    """One rank of phase 32: joins the group (gloo where the ranks share the
    card, NCCL where each has its own), then (a) ``sp_fir`` and
    ``sp_fir_stream`` over the global mesh of ``MH_RANKS`` × ``MH_LOGICAL``
    devices, timed, and (b) ``MH_TRAIN_STEPS`` data-parallel train steps over
    a global ("dp",) mesh; writes ``rank<r>.json`` and, on rank 0, the
    outputs to compare under ``out_dir``."""
    import json as _json
    import os

    import torch
    torch.set_num_threads(1)
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.models.mcldnn import MCLDNN, init_params, loss_fn
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.parallel import (ShardedTrainStep, multihost, place,
                                              sp_fir, sp_fir_stream, to_host)
    multihost.initialize(coordinator, MH_RANKS, rank, device=DEVICE)
    report = {"rank": rank, "backend": multihost.backend(),
              "card": torch.cuda.get_device_name(torch.cuda.current_device()),
              "cards": torch.cuda.device_count()}
    # (a) the sequence-parallel FIR, its halos across the ranks
    config().virtual_devices = MH_LOGICAL
    mesh = multihost.global_mesh(("sp",))
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    frames = _mh_frames()
    fn = sp_fir(taps, mesh)
    xs = place(torch.from_numpy(frames[0]), mesh)
    ck.reset_launches()
    y = fn(xs)                              # warm: the kernel's first launches
    torch.cuda.synchronize()
    multihost.barrier()
    mesh.reset_counts()
    t0 = time.perf_counter()
    for _ in range(MH_REPS):
        y = fn(xs)
    torch.cuda.synchronize()
    multihost.barrier()
    report["us_a_frame"] = (time.perf_counter() - t0) / MH_REPS * 1e6
    report["halos_a_frame"] = mesh.rank_transfers["ppermute"] / MH_REPS
    report["halo_bytes_a_frame"] = mesh.rank_transfer_bytes / MH_REPS
    report["local_copies_a_frame"] = (mesh.transfers["ppermute"]
                                      - mesh.rank_transfers["ppermute"]) / MH_REPS
    report["shards"] = [i for i, s in enumerate(y.shards) if s is not None]
    whole = to_host(y)
    sfn, init_carry = sp_fir_stream(taps, mesh)
    carry = init_carry(np.complex64)
    outs = []
    for f in frames:
        carry, ys = sfn(carry, place(torch.from_numpy(f), mesh))
        outs.append(to_host(ys))
    torch.cuda.synchronize()
    stream = np.concatenate(outs)
    report["fir_launches"] = ck.launches["fir"]
    report["frames_driven"] = 1 + MH_REPS + MH_STREAM_FRAMES
    report["sha_sp_fir"], report["sha_stream"] = _sha(whole), _sha(stream)
    if rank == 0:
        np.save(os.path.join(out_dir, "sp_fir.npy"), whole)
        np.save(os.path.join(out_dir, "stream.npy"), stream)
    # (b) the data-parallel train step, its all-reduce across the ranks
    config().virtual_devices = 1
    mesh_dp = multihost.global_mesh(("dp",))
    widths, n = _mcldnn_v1()
    model = init_params(MCLDNN(**widths), torch.Generator().manual_seed(SEED))
    step = ShardedTrainStep(model, mesh_dp, loss_fn, "dp", None)
    losses, times = [], []
    for i, (X, lab) in enumerate(_mh_batches(n)):
        X, lab = torch.from_numpy(X), torch.from_numpy(lab)
        multihost.barrier()
        t0 = time.perf_counter()
        loss, _acc = step(X, lab)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        every = multihost.process_allgather(loss.reshape(1)).cpu().numpy().reshape(-1)
        if not (every == every[0]).all():
            raise SystemExit(f"rank {rank}: step {i} losses differ across ranks: {every}")
        losses.append(float(every[0]))
        if i == 0 and rank == 0:
            np.savez(os.path.join(out_dir, "step1.npz"),
                     **{k: v.numpy() for k, v in step.state_dict().items()})
    report["losses"] = losses
    report["train_ms"] = statistics.median(times[1:])
    report["dp_psum_a_step"] = mesh_dp.transfers["psum"] / MH_TRAIN_STEPS
    multihost.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        _json.dump(report, f)
    print(f"rank {rank} OK", flush=True)
    return 0


def _one_process_sp(dev, taps, frames) -> dict:
    """(a)'s one-process runs: the same mesh of 4 logical devices on the card
    in this process, timed as the ranks time theirs."""
    import torch

    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.parallel import (make_mesh, place, sp_fir, sp_fir_stream,
                                              to_host)
    cfg = config()
    prev = cfg.virtual_devices
    cfg.virtual_devices = MH_RANKS * MH_LOGICAL
    try:
        mesh = make_mesh(("sp",), shape=(MH_RANKS * MH_LOGICAL,), device=dev)
        fn = sp_fir(taps, mesh)
        xs = place(torch.from_numpy(frames[0]), mesh)
        y = fn(xs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MH_REPS):
            y = fn(xs)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / MH_REPS * 1e6
        whole = to_host(y)
        sfn, init_carry = sp_fir_stream(taps, mesh)
        carry = init_carry(np.complex64)
        outs = []
        for f in frames:
            carry, ys = sfn(carry, f)
            outs.append(to_host(ys))
    finally:
        cfg.virtual_devices = prev
    return {"us": us, "sp_fir": whole, "stream": np.concatenate(outs)}


def _one_process_train(dev) -> dict:
    """(b)'s one-device step on the whole batch: its first step's weights and
    gradients, and ms a step over the same batches."""
    import torch

    from futuresdr_tpu_torch.models.mcldnn import (MCLDNN, init_params, make_train_step,
                                                   trainable_parameters)
    widths, n = _mcldnn_v1()
    m = init_params(MCLDNN(**widths).to(dev), torch.Generator().manual_seed(SEED))
    step = make_train_step(m, torch.optim.Adam(trainable_parameters(m), lr=1e-3))
    times, losses, first = [], [], None
    for i, (X, lab) in enumerate(_mh_batches(n)):
        X, lab = torch.from_numpy(X), torch.from_numpy(lab)
        t0 = time.perf_counter()
        loss, _acc = step(X.to(dev), lab.to(dev))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if i == 0:
            first = ({k: v.detach().cpu().numpy().copy() for k, v in m.state_dict().items()},
                     {k: None if p.grad is None else p.grad.detach().cpu().numpy().copy()
                      for k, p in m.named_parameters()})
    return {"ms": statistics.median(times[1:]), "losses": losses, "first": first}


def phase_mh_ranks(dev, card_line) -> dict:
    """32 (a), (b): two rank processes on the card (module docstring), held
    against this process's one-process runs and the kernel's plain version."""
    import json as _json
    import os
    import shutil

    import torch

    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.parallel import multihost
    out_dir = _build_dir().parent / "phase32"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    script = os.path.abspath(__file__)
    t0 = time.perf_counter()
    results = multihost.launch(
        lambda r, c: [sys.executable, script, "--rank", str(r), "--coordinator", c,
                      "--rank-dir", str(out_dir)],
        MH_RANKS, MH_RANK_TIMEOUT_S, cwd=os.path.dirname(script))
    ranks_s = time.perf_counter() - t0
    for r, (rc, out) in enumerate(results):
        check(rc == 0 and f"rank {r} OK" in out,
              f"multihost: rank {r} failed (rc {rc}):\n{out[-4000:]}")
    reports = [_json.load(open(out_dir / f"rank{r}.json")) for r in range(MH_RANKS)]
    be = reports[0]["backend"]
    check(all(rep["backend"] == be for rep in reports), "multihost: the ranks' backends differ")
    cards = reports[0]["cards"]
    why = (f"{cards} card(s) for {MH_RANKS} ranks: they share card 0, and NCCL takes a "
           f"card a rank; the halos are staged through pinned host memory, the stand-in "
           f"for a network link" if be == "gloo" else f"{cards} cards: one a rank")
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    frames = _mh_frames()
    one = _one_process_sp(dev, taps, frames)
    whole = np.load(out_dir / "sp_fir.npy")
    stream = np.load(out_dir / "stream.npy")
    check(all(rep["sha_sp_fir"] == _sha(whole) and rep["sha_stream"] == _sha(stream)
              for rep in reports), "multihost: the ranks gathered different outputs")
    check(np.array_equal(whole, one["sp_fir"]),
          "multihost (a): sp_fir at 2 ranks differs from the one-process 4-device run")
    check(np.array_equal(stream, one["stream"]),
          "multihost (a): sp_fir_stream at 2 ranks differs from the one-process stream")
    tt = torch.from_numpy(taps).to(dev)
    plain = ck.fir_plain(torch.from_numpy(np.concatenate(frames)).to(dev), tt).cpu().numpy()
    err_a, peak_a = _peak_err(whole, plain[:MH_FRAME])
    err_s, peak_s = _peak_err(stream, plain)
    check(err_a <= MH_TOL * peak_a and err_s <= MH_TOL * peak_s,
          f"multihost (a): {err_a:.3g} / {err_s:.3g} from the fir kernel's plain version "
          f"(peaks {peak_a:.3g} / {peak_s:.3g}, limit {MH_TOL} of peak)")
    for rep in reports:
        check(rep["fir_launches"] >= rep["frames_driven"] * MH_LOGICAL,
              f"multihost (a): rank {rep['rank']} launched fir {rep['fir_launches']} times "
              f"for {rep['frames_driven']} frames of {MH_LOGICAL} shards")
    check(reports[1]["halos_a_frame"] == 1 and reports[0]["halos_a_frame"] == 0,
          f"multihost (a): cross-rank halos a frame {[r['halos_a_frame'] for r in reports]}, "
          f"want [0, 1]")
    # (b)
    ref = _one_process_train(dev)
    losses = [rep["losses"] for rep in reports]
    check(losses[0] == losses[1], "multihost (b): the ranks saw different losses")
    check(all(np.isfinite(losses[0])), f"multihost (b): a loss is not finite: {losses[0]}")
    want, grads = ref["first"]
    got = np.load(out_dir / "step1.npz")
    worst = 0.0
    for name, w in want.items():
        g = grads.get(name)
        if g is None:
            check(np.array_equal(got[name], w), f"multihost (b): frozen {name} moved")
            continue
        keep = np.abs(g) > MH_TINY_G
        worst = max(worst, float(np.abs(got[name][keep] - w[keep]).max(initial=0.0)))
    check(worst <= MH_STEP_TOL, f"multihost (b): the first step's weights are {worst:.3g} "
                                f"from the one-process step's (limit {MH_STEP_TOL})")
    rank_us = statistics.median(rep["us_a_frame"] for rep in reports)
    each_us = ", ".join(f"{rep['us_a_frame']:.1f}" for rep in reports)
    each_ms = ", ".join(f"{rep['train_ms']:.3f}" for rep in reports)
    print(f"phase 32 (a) sp_fir c64 frame {MH_FRAME}, {N_TAPS} taps, {MH_RANKS} ranks x "
          f"{MH_LOGICAL} logical devices over {be} ({why}): {rank_us:.1f} us a frame "
          f"(ranks {each_us}), one process x "
          f"{MH_RANKS * MH_LOGICAL} logical devices {one['us']:.1f} us a frame; cross-rank "
          f"halos a frame {sum(r['halos_a_frame'] for r in reports):g} "
          f"({sum(r['halo_bytes_a_frame'] for r in reports):g} B), in-rank copies "
          f"{sum(r['local_copies_a_frame'] for r in reports):g}; fir launches a rank "
          f"{[r['fir_launches'] for r in reports]} over {reports[0]['frames_driven']} frames; "
          f"bit-equal to one process, {err_a / peak_a:.3g} of peak from plain [{card_line}]")
    print(f"phase 32 (a) sp_fir_stream {MH_STREAM_FRAMES} frames, carry chained across the "
          f"ranks: bit-equal to one process, {err_s / peak_s:.3g} of peak from plain")
    print(f"phase 32 (b) train mcldnn_v1 batch {MH_TRAIN_BATCH} over {MH_RANKS} ranks "
          f"({be}), {MH_TRAIN_STEPS} steps: {statistics.median(r['train_ms'] for r in reports):.3f} "
          f"ms a step (median of steps 2-{MH_TRAIN_STEPS}; ranks {each_ms}), one process "
          f"{ref['ms']:.3f} ms a step; the same loss on both ranks every step "
          f"({losses[0][0]:.4f} -> {losses[0][-1]:.4f}; one process "
          f"{ref['losses'][0]:.4f} -> {ref['losses'][-1]:.4f}); first step's weights "
          f"{worst:.3g} from the one-process step's [{card_line}]")
    print(f"phase 32 ranks: {ranks_s:.1f} s for both ({MH_RANKS} processes to the card and "
          f"back)")
    return {"launches": {"fir": sum(r["fir_launches"] for r in reports)},
            "backend": be, "rank_us": rank_us, "one_us": one["us"],
            "train_ms": [r["train_ms"] for r in reports], "one_train_ms": ref["ms"]}


def phase_mh_entry(dev, card_line) -> dict:
    """32 (c): ``entry()`` on the card against the CPU, and
    ``dryrun_multichip(4)`` on 4 logical devices on the card; the kernels'
    launches over the dryrun."""
    import torch

    from futuresdr_tpu_torch.entry import dryrun_multichip, entry
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    fn, (model, batch) = entry(device=dev)
    got = fn(model, batch).cpu().numpy()
    cfn, (cmodel, cbatch) = entry(device="cpu")
    want = cfn(cmodel, cbatch).numpy()
    err, peak = _peak_err(got, want)
    check(got.shape == (8, 11) and err <= MH_ENTRY_TOL * peak,
          f"entry(): logits {err:.3g} from the CPU's (peak {peak:.3g}, limit {MH_ENTRY_TOL} "
          f"of peak)")
    ck.reset_launches()
    t0 = time.perf_counter()
    dryrun_multichip(MH_DRYRUN_DEVICES, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: ck.launches[k] for k in MH_KERNELS}
    for k in MH_KERNELS:
        check(counts[k] > 0, f"dryrun_multichip: kernel {k} was launched no time")
    print(f"phase 32 (c) entry(): logits [8, 11] {err / peak:.3g} of peak from the CPU; "
          f"dryrun_multichip({MH_DRYRUN_DEVICES}) on {MH_DRYRUN_DEVICES} logical devices on "
          f"the card: {dt:.1f} s, launches " + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f" [{card_line}]")
    return counts


def _lora_capture():
    """``LORA_SCAN_FRAMES`` frames of the port's ``modulate_frame`` at SF
    ``LORA_SCAN_SF`` with gaps, white noise at ``LORA_SCAN_SNR_DB`` dB, the
    length a multiple of the 4 shards' hop."""
    from futuresdr_tpu_torch.models.lora import LoraParams, modulate_frame
    p = LoraParams(sf=LORA_SCAN_SF)
    rng = np.random.default_rng(SEED + 322)
    parts = []
    for i in range(LORA_SCAN_FRAMES):
        parts += [np.zeros(p.n + 97 * i, np.complex64),
                  modulate_frame(f"scan {i}".encode(), p)]
    x = np.concatenate(parts)
    quantum = MH_DRYRUN_DEVICES * p.n
    x = np.concatenate([x, np.zeros(-len(x) % quantum, np.complex64)])
    sigma = 10 ** (-LORA_SCAN_SNR_DB / 20) / np.sqrt(2)
    return (x + sigma * (rng.standard_normal(len(x))
                         + 1j * rng.standard_normal(len(x)))).astype(np.complex64)


def phase_mh_lora(dev, card_line) -> dict:
    """32 (d): the LoRa loopback app at SF 7 and SF 12, and ``sp_dechirp_scan``
    at SF 12 over a modulated capture on 4 logical devices on the card
    against the host scan."""
    import torch

    from futuresdr_tpu_torch.apps.lora_loopback import run
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.parallel import make_mesh, place, sp_dechirp_scan, to_host
    rates = {}
    for sf, n_frames in LORA_LOOPBACK_FRAMES.items():
        sent, got, crc, seconds = run(frames=n_frames, sf=sf)
        check(got == sent and all(crc),
              f"lora loopback SF{sf}: decoded {got} of {sent}, CRC {crc}")
        rates[sf] = n_frames / seconds
    x = _lora_capture()
    cfg = config()
    prev = cfg.virtual_devices
    cfg.virtual_devices = MH_DRYRUN_DEVICES
    try:
        mesh = make_mesh(("sp",), shape=(MH_DRYRUN_DEVICES,), device=dev)
        fn = sp_dechirp_scan(LORA_SCAN_SF, mesh)
        xs = place(torch.from_numpy(x), mesh)
        bins, conc = fn(xs)
        bins, conc = to_host(bins), to_host(conc)
        times = []
        for _ in range(LORA_SCAN_REPS):
            t0 = time.perf_counter()
            fn(xs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        cfg.virtual_devices = prev
    host = make_mesh(("sp",), shape=(1,), device="cpu")
    hb, hc = sp_dechirp_scan(LORA_SCAN_SF, host)(x)
    hb, hc = to_host(hb), to_host(hc)
    check(np.array_equal(bins, hb), f"lora scan: {int((bins != hb).sum())} of {len(hb)} "
                                    f"windows' bins differ from the host scan's")
    err = float(np.abs(conc - hc).max())
    check(err <= LORA_SCAN_TOL, f"lora scan: concentrations {err:.3g} from the host scan's "
                                f"(limit {LORA_SCAN_TOL})")
    found = int((hc > 0.5).sum())
    check(found > 0, "lora scan: no preamble window found")
    msps = len(x) / statistics.median(times) / 1e6
    print(f"phase 32 (d) lora loopback app: SF7 {LORA_LOOPBACK_FRAMES[7]} frames "
          f"{rates[7]:.1f} frames/s, SF12 {LORA_LOOPBACK_FRAMES[12]} frames {rates[12]:.1f} "
          f"frames/s, every payload decoded, CRC ok (host) [{card_line}]")
    print(f"phase 32 (d) sp_dechirp_scan SF{LORA_SCAN_SF} over {LORA_SCAN_FRAMES} frames at "
          f"{LORA_SCAN_SNR_DB:g} dB ({len(x)} samples, {len(hb)} windows, {found} above 0.5) "
          f"on {MH_DRYRUN_DEVICES} logical devices: bins equal to the host scan's, "
          f"concentrations {err:.3g} from them; {msps:.1f} Msamples/s scanned [{card_line}]")
    return {"loopback_fps": rates, "scan_msps": msps}


def phase_multihost(dev, card_line) -> dict:
    """Phase 32: (a), (b) two rank processes, (c) the entry points, (d) LoRa.
    The kernels' launches: the ranks' ``fir`` over their drives and this
    process's over the dryrun."""
    t0 = time.perf_counter()
    ranks = phase_mh_ranks(dev, card_line)
    entry_counts = phase_mh_entry(dev, card_line)
    lora = phase_mh_lora(dev, card_line)
    launches = {k: entry_counts.get(k, 0) + ranks["launches"].get(k, 0) for k in MH_KERNELS}
    print(f"phase 32: {time.perf_counter() - t0:.1f} s, launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    return {"launches": launches, "ranks": ranks, "lora": lora}


# ---------------------------------------------------------------------------
# phase 33: the remaining models (M17, ZigBee, ADS-B, Rattlegram, misc)
# ---------------------------------------------------------------------------

PROTO_M17_STEPS = (512, 1024, 4096)   # (a)'s frames, trellis steps
PROTO_M17_SIGMA = 0.5         # noise on (a)'s ±1 soft bits: Es/N0 6 dB
PROTO_M17_REPS = 20           # timed calls a frame length (median)
PROTO_M17_BEACONS = 3         # the loopback app's default beacons
PROTO_M17_PAYLOAD = bytes(range(64))   # 4 stream frames of 16 bytes
# (b)'s timed stream: transmissions of an LSF and this many stream frames
# each (208 frames), noise 0.05, through the receiver alone, runs timed
PROTO_M17_STREAM = (16, 12)
PROTO_M17_STREAM_RUNS = 3
# ADS-B (d): the odd frame's local CPR solution at the app's site
# (tests/test_adsb.py test_cpr_local_decode_with_reference, within 1e-6) and
# the published position (test_tracker_integration, within 0.01 in latitude)
PROTO_ADSB_ODD = (52.2657801, 3.9389125)
PROTO_ADSB_PUBLISHED_LAT = 52.2572
PROTO_CW_TEXT = "CQ CQ DE FUTURESDR TPU K"


def _m17_frame(rng, n_steps):
    """Soft bits of a random terminated M17 frame of ``n_steps`` trellis steps
    at its P2 puncturing (``PROTO_M17_SIGMA`` on ±1, zeros where punctured)
    and its bits."""
    from futuresdr_tpu_torch.models.m17 import codec
    bits = np.concatenate([rng.integers(0, 2, n_steps - 4), np.zeros(4)]).astype(np.uint8)
    coded = codec.conv_encode_m17(bits)
    sent = codec.puncture_p2(coded).astype(np.float64) * 2 - 1
    sent += PROTO_M17_SIGMA * rng.standard_normal(len(sent))
    return codec.depuncture_p2(sent, len(coded)), bits


def phase_m17_viterbi(dev, card_line) -> dict:
    """33 (a): ``viterbi_decode_m17`` on the card through the port's M17 codec
    at ``PROTO_M17_STEPS``: one call a frame drives the path (its launches
    counted over those calls alone), the bits equal to the float64 numpy
    trellis and to ``ops/viterbi``'s plain version on the CPU, bit for bit;
    then µs a call (host to host) and the kernel's card time for the frame's
    bucket beside its bound and the plain version's time on the card."""
    import torch

    from futuresdr_tpu_torch.models.m17 import codec, viterbi_decode_m17
    from futuresdr_tpu_torch.ops import viterbi as V
    from futuresdr_tpu_torch.utils.roofline import kernel_cost
    rng = np.random.default_rng(SEED + 330)
    frames = {n: _m17_frame(rng, n) for n in PROTO_M17_STEPS}
    V.reset_launches()
    got = {n: viterbi_decode_m17(llrs, n, device=dev) for n, (llrs, _) in frames.items()}
    torch.cuda.synchronize()
    launches = V.launches["viterbi"]
    check(launches == len(PROTO_M17_STEPS),
          f"m17 viterbi: {launches} launches for {len(PROTO_M17_STEPS)} frames")
    out = {"launches": launches, "frames": {}}
    for n, (llrs, bits) in frames.items():
        t0 = time.perf_counter()
        want = codec._viterbi_numpy(llrs, n)
        numpy_ms = (time.perf_counter() - t0) * 1e3
        plain = V.scan_viterbi(np.asarray(llrs, np.float32), n, *codec._M17_PREV,
                               device="cpu")
        diff = int((got[n] != want).sum())
        check(diff == 0, f"m17 viterbi {n} steps: {diff} bits differ from the numpy trellis")
        diff = int((got[n] != plain).sum())
        check(diff == 0, f"m17 viterbi {n} steps: {diff} bits differ from the plain version")
        ber = float((got[n] != bits).mean())
        times = []
        for _ in range(PROTO_M17_REPS):
            t0 = time.perf_counter()
            viterbi_decode_m17(llrs, n, device=dev)
            times.append(time.perf_counter() - t0)
        call_us = statistics.median(times) * 1e6
        T = V.bucket_steps(n)
        lams = np.zeros((1, T, 2), np.float32)
        lams[0, :n] = np.asarray(llrs[:2 * n], np.float32).reshape(n, 2)
        tables = V._tables(*codec._M17_PREV, dev)
        steps = torch.tensor([n], dtype=torch.int32, device=dev)
        args = [(torch.from_numpy(lams).to(dev),)] * 4
        kernel_ms = device_ms(lambda x: V.decode(x, steps, *tables), args)
        ps, pb, b0, b1 = tables
        plain_ms = cuda_ms(lambda: V.traceback_plain(
            V._survivors_plain(args[0][0], steps, ps, b0, b1), steps, ps, pb), reps=1)
        nbytes, ops = kernel_cost("viterbi", B=1, T=T, S=16, steps=n)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
        row = {"call_us": call_us, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "numpy_ms": numpy_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations", "ber": ber}
        out["frames"][n] = row
        print(f"phase 33 (a) m17 viterbi_decode_m17 {n} steps (bucket {T}, P2 puncturing, "
              f"noise {PROTO_M17_SIGMA:g} on ±1, BER {ber:.4f}): bits equal to the numpy "
              f"trellis and the plain version; {call_us:.1f} us a call host to host "
              f"(median of {PROTO_M17_REPS}), kernel {kernel_ms * 1e3:.1f} us on the card, "
              f"bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}), plain version "
              f"{plain_ms:.1f} ms on the card, numpy trellis {numpy_ms:.1f} ms on the host "
              f"[{card_line}]")
    V.reset_launches()
    return out


def _m17_stream_rate(card_line) -> dict:
    """33 (b)'s rate: ``PROTO_M17_STREAM`` transmissions (an LSF and their
    stream frames each, 40 symbols apart, noise 0.05) from a ``VectorSource``
    through ``M17Receiver`` in a flowgraph, every transmission decoded, over
    ``PROTO_M17_STREAM_RUNS`` runs. The flowgraph's start and stop are taken
    out: each run also times the same flowgraph over 64 symbols of silence,
    and the rate is the frames over the difference."""
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.models.m17 import M17Receiver
    from futuresdr_tpu_torch.models.m17.phy import (SPS, Lsf, build_stream_frames,
                                                    modulate)
    from futuresdr_tpu_torch.runtime import Flowgraph, Runtime
    n_tx, n_stream = PROTO_M17_STREAM
    rng = np.random.default_rng(SEED + 331)
    parts, sent = [], []
    for _ in range(n_tx):
        payload = rng.integers(0, 256, 16 * n_stream, dtype=np.uint8).tobytes()
        parts += [modulate(build_stream_frames(Lsf(dst="SP5WWP", src="N0CALL"), payload)),
                  np.zeros(40 * SPS, np.float32)]
        sent.append(payload)
    x = np.concatenate(parts)
    x = (x + 0.05 * rng.standard_normal(len(x))).astype(np.float32)
    n_frames = n_tx * (1 + n_stream)

    def run(items):
        fg, rx = Flowgraph(), M17Receiver()
        fg.connect(VectorSource(items), rx)
        t0 = time.perf_counter()
        Runtime().run(fg)
        return time.perf_counter() - t0, rx

    rates, idle = [], []
    for _ in range(PROTO_M17_STREAM_RUNS):
        t_idle, _ = run(np.zeros(64 * SPS, np.float32))
        t_run, rx = run(x)
        check([p for _, p in rx.transmissions] == sent and len(rx.frames) == n_tx,
              f"m17 stream: {len(rx.transmissions)} of {n_tx} transmissions, "
              f"{len(rx.frames)} LSFs")
        idle.append(t_idle)
        rates.append(n_frames / (t_run - t_idle))
    print(f"phase 33 (b) m17 receiver on a stream of {n_tx} transmissions x (1 LSF + "
          f"{n_stream} stream frames) = {n_frames} frames, {len(x)} samples, every one "
          f"decoded: {', '.join(f'{r:.2f}' for r in rates)} frames/s on the host over "
          f"{PROTO_M17_STREAM_RUNS} runs (the flowgraph's start and stop, "
          f"{', '.join(f'{t * 1e3:.1f}' for t in idle)} ms, taken out) [{card_line}]")
    return {"frames": n_frames, "frames_per_s": rates, "start_stop_s": idle}


def phase_protocol_apps(dev, card_line) -> dict:
    """33 (b)-(f): the apps of the remaining models on the card machine,
    each decoding every frame it sent, and M17's receiver timed on a long
    stream."""
    from futuresdr_tpu_torch.apps import (adsb_rx, cw_beacon, m17_loopback, modem_ota,
                                          rattlegram_loopback, zigbee_loopback)
    from futuresdr_tpu_torch.models.adsb import decode_frame, detect_and_demodulate
    from futuresdr_tpu_torch.ops import _build
    # (b) M17: the app's three beacons, then a 4-frame stream transmission
    metas, lsfs, transmissions, _ = m17_loopback.run(
        frames=PROTO_M17_BEACONS, payload=PROTO_M17_PAYLOAD)
    check([f.meta for f in lsfs] == metas + [bytes(14)],
          f"m17 loopback: LSFs {[f.meta for f in lsfs]}, sent {metas} and the "
          f"transmission's own")
    check([p for _, p in transmissions] == [PROTO_M17_PAYLOAD],
          f"m17 loopback: transmissions {transmissions}")
    n_stream = len(PROTO_M17_PAYLOAD) // 16
    n_frames = PROTO_M17_BEACONS + 1 + n_stream
    print(f"phase 33 (b) m17 loopback app: {PROTO_M17_BEACONS} LSF beacons and a "
          f"{n_stream}-frame stream transmission ({n_frames} frames at 4,800 symbols/s, 10 "
          f"samples a symbol), every one decoded [{card_line}]")
    m17 = _m17_stream_rate(card_line)
    # (c) ZigBee: the app's four frames, every FCS good
    sent, got, _ = zigbee_loopback.run()
    check(got == sent, f"zigbee loopback: decoded {got} of {sent}")
    print(f"phase 33 (c) zigbee loopback app: {len(got)}/{len(sent)} frames decoded with a "
          f"good FCS, in order (O-QPSK, 4 samples a chip) [{card_line}]")
    # (d) ADS-B on its synthesized stream
    rx, _ = adsb_rx.run()
    msgs = [decode_frame(b) for _, b in detect_and_demodulate(adsb_rx.synth_stream())]
    checked = [m for m in msgs if m is not None and not m.icao_derived]
    check(len(msgs) == len(adsb_rx.SYNTH_FRAMES) and checked
          and all(m.crc_ok for m in checked),
          f"adsb: {len(msgs)} of {len(adsb_rx.SYNTH_FRAMES)} frames detected, CRC24 "
          f"{[m.crc_ok for m in checked]}")
    check(rx.n_frames == len(adsb_rx.SYNTH_FRAMES) - 1,
          f"adsb receiver: {rx.n_frames} frames, not the {len(adsb_rx.SYNTH_FRAMES) - 1} "
          f"the tracker's gate passes")
    ac = rx.tracker.aircraft.get(0x40621D)
    check(ac is not None and ac.lat is not None
          and abs(ac.lat - PROTO_ADSB_ODD[0]) < 1e-6 and abs(ac.lon - PROTO_ADSB_ODD[1]) < 1e-6
          and abs(ac.lat - PROTO_ADSB_PUBLISHED_LAT) < 0.01,
          f"adsb: 40621D at {None if ac is None else (ac.lat, ac.lon)}")
    check(rx.tracker.aircraft[0x4840D6].callsign == "KLM1023", "adsb: no KLM1023")
    print(f"phase 33 (d) adsb_rx on its synthesized stream (2 Msps): {rx.n_frames} frames "
          f"tracked, {len(checked)} with a good CRC24, 40621D at ({ac.lat:.7f}, "
          f"{ac.lon:.7f}) [{card_line}]")
    # (e) Rattlegram: the loopback app, and modem_ota with and without metadata
    sent, got, _ = rattlegram_loopback.run()
    check(got == sent, f"rattlegram loopback: decoded {got} of {sent}")
    message = "hello through the speaker"
    _, cs, plain = modem_ota.run(message)
    _, cs_meta, meta = modem_ota.run(message, callsign="N0CALL")
    check(plain == message.encode() and cs is None,
          f"modem_ota: decoded {plain!r}, not {message!r}")
    check(meta == message.encode() and cs_meta == "N0CALL",
          f"modem_ota --callsign N0CALL: decoded {meta!r} from {cs_meta!r}")
    print(f"phase 33 (e) rattlegram loopback app: {len(got)}/{len(sent)} payloads; "
          f"modem_ota without and with the callsign metadata (N0CALL): decoded "
          f"[{card_line}]")
    # (f) the CW beacon, decoded from its WAV file
    wav = _build.BUILD_DIR.parent / "cw_smoke.wav"
    _, decoded = cw_beacon.run(PROTO_CW_TEXT, str(wav))
    wav.unlink()
    check(decoded == PROTO_CW_TEXT, f"cw beacon: {decoded!r} from its WAV file, not "
                                    f"{PROTO_CW_TEXT!r}")
    print(f"phase 33 (f) cw beacon: {decoded!r} recovered from its WAV file [{card_line}]")
    return {"m17": m17}


def phase_protocols(dev, card_line) -> dict:
    """Phase 33: (a) M17's long frames on the Viterbi kernel, (b)-(f) the
    apps of M17, ZigBee, ADS-B, Rattlegram and the CW beacon. The kernel's
    launches: (a)'s decode calls."""
    t0 = time.perf_counter()
    viterbi = phase_m17_viterbi(dev, card_line)
    apps = phase_protocol_apps(dev, card_line)
    print(f"phase 33: {time.perf_counter() - t0:.1f} s, launches viterbi "
          f"{viterbi['launches']}")
    return {"launches": viterbi["launches"], "viterbi": viterbi, "apps": apps}


# ---- phase 34: the host plane ----------------------------------------------------

HP_PIPES = 5                    # perf/fir.py's grid
HP_STAGES = 6
HP_SAMPLES = 15_000_000
HP_MAX_COPY = 4096
HP_NATIVE_RUNS = 3
HP_SCHEDULERS = ("async", "threaded", "tpb")
HP_CHECK_SAMPLES = 1 << 20      # the VectorSource-fed 1 x 6 pipe of (a)'s check
HP_TOL = 1e-5                   # of peak: native against actor, kernel against host
HP_TPU_FRAME = 1 << 18
HP_TPU_SCHEDULERS = ("threaded", "async")
HP_TPU_CHECK = 4 * HP_TPU_FRAME # (b)'s seeded input a pipe
HP_FILE_SAMPLES = 1 << 22       # (d)'s complex64 file
HP_APPS = {
    "keyfob_rx": ([], "# loopback OK: code round-tripped"),
    "keyfob_rx tx": (["tx", "--out", "{d}/burst.cf32"], "0xA53C96"),
    "ssb_rx": (["--wav", "{d}/ssb.wav"], "# loopback OK: both test tones recovered"),
    "file_trx": (["rx", "--out", "{d}/cap.cs8", "--samples", "50000"], "wrote 50000 items"),
    "custom_routes": (["--port", "0"], "GET /api/fg/   -> [0, 1]"),
    "adsb_rx": (["--file", "{d}/adsb.f32"], "decoded 6 frames"),
}


def _scheduler(name):
    from futuresdr_tpu_torch import AsyncScheduler, ThreadedScheduler, TpbScheduler
    return {"async": AsyncScheduler, "threaded": ThreadedScheduler,
            "tpb": TpbScheduler}[name]()


def _hp_grid(taps, tpu_dev=None, data=None):
    """``perf/fir.py``'s grid: NullSource -> Head -> stages -> NullSink a pipe
    (``data``: one pipe of VectorSource -> stages -> VectorSink instead), the
    stages ``CopyRand -> Fir`` or, with ``tpu_dev``, one ``TpuKernel`` of
    ``fir_stage(impl="pallas")``; returns ``(flowgraph, sinks)``."""
    from futuresdr_tpu_torch import Flowgraph
    from futuresdr_tpu_torch.blocks import (CopyRand, Fir, Head, NullSink, NullSource,
                                            VectorSink, VectorSource)
    fg = Flowgraph()
    sinks = []
    for p in range(HP_PIPES if data is None else len(data)):
        if data is None:
            last = Head(np.float32, HP_SAMPLES)
            fg.connect(NullSource(np.float32), last)
        else:
            last = VectorSource(data[p])
            fg.add(last)
        if tpu_dev is not None:
            from futuresdr_tpu_torch.ops.stages import fir_stage
            from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
            blk = TpuKernel([fir_stage(taps, name=f"fir{i}", impl="pallas")
                             for i in range(HP_STAGES)], np.float32,
                            frame_size=HP_TPU_FRAME, inst=TpuInstance(tpu_dev), wire="f32")
            fg.connect(last, blk)
            last = blk
        else:
            for s in range(HP_STAGES):
                cr, fir = CopyRand(np.float32, HP_MAX_COPY, seed=s + 1), Fir(taps, np.float32)
                fg.connect(last, cr, fir)
                last = fir
        snk = NullSink(np.float32) if data is None else VectorSink(np.float32)
        fg.connect(last, snk)
        sinks.append(snk)
    return fg, sinks


def _hp_run(fg, sched: str) -> float:
    from futuresdr_tpu_torch import Runtime
    rt = Runtime(_scheduler(sched))
    t0 = time.perf_counter()
    rt.run(fg)
    dt = time.perf_counter() - t0
    rt.shutdown()
    return dt


class _actor_path:
    """``FSDR_NO_FASTCHAIN=1`` for the block, as perf probes A/B the paths."""

    def __enter__(self):
        import os
        os.environ["FSDR_NO_FASTCHAIN"] = "1"

    def __exit__(self, *exc):
        import os
        os.environ.pop("FSDR_NO_FASTCHAIN", None)


def _hp_counts(sinks, slack: int, what: str) -> None:
    """Every sink's count as ``perf/fir.py:63-65`` checks it."""
    for s in sinks:
        check(HP_SAMPLES - slack <= s.n_received <= HP_SAMPLES + slack,
              f"{what}: a sink received {s.n_received} of {HP_SAMPLES}")


def _host_cascade(x, taps):
    y = x
    for _ in range(HP_STAGES):
        y = np.convolve(y, taps)[:len(y)].astype(np.float32)
    return y


def phase_hostplane_grid(card_line, actor_runs: int) -> dict:
    """34 (a): the grid natively fused and on the actor path under each
    scheduler, Msamples/s in total; the native pipe against the actor's."""
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.runtime import fastchain
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    total = HP_PIPES * HP_SAMPLES
    out = {"native": [], "avx512": fastchain.avx512_built()}
    print(f"phase 34 (a) fast chain: library built, AVX-512 FIR path "
          f"{'built' if out['avx512'] else 'not built (the CPU has no AVX-512F)'}")
    for r in range(HP_NATIVE_RUNS):
        fg, sinks = _hp_grid(taps)
        check(len(fastchain.find_native_chains(fg)) == HP_PIPES,
              "34 (a): the grid's pipes did not fuse")
        dt = _hp_run(fg, "async")
        _hp_counts(sinks, 0, "native grid")
        out["native"].append(total / dt / 1e6)
        print(f"phase 34 (a) grid {HP_PIPES} x {HP_STAGES} native run {r}: {dt:.3f} s, "
              f"{out['native'][-1]:.1f} Msamples/s in total")
    for sched in HP_SCHEDULERS:
        out[sched] = []
        for r in range(actor_runs):
            with _actor_path():
                fg, sinks = _hp_grid(taps)
                dt = _hp_run(fg, sched)
            _hp_counts(sinks, 64 * HP_STAGES + 1, f"actor grid ({sched})")
            out[sched].append(total / dt / 1e6)
            print(f"phase 34 (a) grid {HP_PIPES} x {HP_STAGES} actor {sched} run {r}: "
                  f"{dt:.3f} s, {out[sched][-1]:.1f} Msamples/s in total")
    # the VectorSource-fed pipe: natively fused against the actor path
    x = np.random.default_rng(SEED).standard_normal((1, HP_CHECK_SAMPLES)).astype(np.float32)
    fg, (nat,) = _hp_grid(taps, data=x)
    check(len(fastchain.find_native_chains(fg)) == 1, "34 (a): the check pipe did not fuse")
    _hp_run(fg, "async")
    with _actor_path():
        fg, (act,) = _hp_grid(taps, data=x)
        _hp_run(fg, "async")
    got, want = nat.items(), act.items()
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    check(len(got) == len(want) == HP_CHECK_SAMPLES and err <= HP_TOL,
          f"34 (a): native pipe {len(got)} items at {err:.3g} of peak from the actor's")
    out["native_err"] = err
    print(f"phase 34 (a) 1 x {HP_STAGES} VectorSource pipe of {HP_CHECK_SAMPLES} samples: "
          f"native within {err:.3g} of peak of the actor path [{card_line}]")
    return out


def phase_hostplane_tpu(dev, card_line) -> dict:
    """34 (b): the grid's ``--tpu`` form under ThreadedScheduler and
    AsyncScheduler, Msamples/s; a seeded pipe against the host cascade."""
    from futuresdr_tpu_torch.dsp import firdes
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    out = {}
    x = np.random.default_rng(SEED + 1).standard_normal((2, HP_TPU_CHECK)).astype(np.float32)
    want = [_host_cascade(x[p], taps) for p in range(2)]
    for sched in HP_TPU_SCHEDULERS:
        fg, sinks = _hp_grid(taps, tpu_dev=dev)
        dt = _hp_run(fg, sched)
        _hp_counts(sinks, 1 << 13, f"tpu grid ({sched})")
        out[sched] = HP_PIPES * HP_SAMPLES / dt / 1e6
        fg, sinks = _hp_grid(taps, tpu_dev=dev, data=x)
        _hp_run(fg, sched)
        for s, w in zip(sinks, want):
            got = s.items()
            err = float(np.abs(got - w).max()) / float(np.abs(w).max())
            check(len(got) == len(w) and err <= HP_TOL,
                  f"34 (b) {sched}: {len(got)} items at {err:.3g} of peak from the host")
            out[f"{sched}_err"] = max(out.get(f"{sched}_err", 0.0), err)
        print(f"phase 34 (b) grid {HP_PIPES} x {HP_STAGES} --tpu ({sched}, frame "
              f"{HP_TPU_FRAME}, f32 wire): {dt:.3f} s, {out[sched]:.1f} Msamples/s in "
              f"total; seeded pipes within {out[f'{sched}_err']:.3g} of peak of the host "
              f"cascade [{card_line}]")
    return out


def phase_hostplane_apps(card_line) -> None:
    """34 (c): the apps' ``main()`` as subprocesses, all started together."""
    import os
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.apps.adsb_rx import synth_stream
    from futuresdr_tpu_torch.blocks import FileSink, VectorSource
    from futuresdr_tpu_torch.ops import _build
    d = _build.BUILD_DIR.parent / "phase34"
    d.mkdir(parents=True, exist_ok=True)
    fg = Flowgraph()
    fg.connect(VectorSource(synth_stream()), FileSink(str(d / "adsb.f32"), np.float32))
    Runtime().run(fg)
    from pathlib import Path
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = {}
    for name, (args, _) in HP_APPS.items():
        mod = "futuresdr_tpu_torch.apps." + name.split()[0]
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", mod, *[a.format(d=d) for a in args]], cwd=str(d),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        try:
            so, _ = p.communicate(timeout=MAIN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            so, _ = p.communicate()
        check(p.returncode == 0 and HP_APPS[name][1] in so,
              f"34 (c) {name}: exit {p.returncode}:\n{so[-3000:]}")
        print(f"phase 34 (c) {name.split()[0]} {' '.join(HP_APPS[name][0]).format(d='.')}: exit 0, "
              f"{HP_APPS[name][1]!r} [{card_line}]")
    print(f"phase 34 (c) six app runs: {time.perf_counter() - t0:.1f} s")


def phase_hostplane_file(dev, card_line) -> dict:
    """34 (d): a complex64 file through the fused spectrum chain on the card
    and back to a file, bit-equal to the same run from a VectorSource."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import FileSink, FileSource, VectorSource
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops import _build
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    d = _build.BUILD_DIR.parent / "phase34"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 2)
    x = (rng.standard_normal(HP_FILE_SAMPLES)
         + 1j * rng.standard_normal(HP_FILE_SAMPLES)).astype(np.complex64)
    x.tofile(d / "in.cf32")
    times = {}
    for src_kind in ("file", "vector"):
        fg = Flowgraph()
        src = (FileSource(str(d / "in.cf32"), np.complex64) if src_kind == "file"
               else VectorSource(x))
        blk = TpuKernel(chain_stages("fused", taps), np.complex64, frame_size=HP_TPU_FRAME,
                        inst=TpuInstance(dev), frames_in_flight=IN_FLIGHT, wire="f32")
        fg.connect(src, blk, FileSink(str(d / f"out_{src_kind}.f32"), np.float32))
        t0 = time.perf_counter()
        Runtime().run(fg)
        times[src_kind] = time.perf_counter() - t0
    a = (d / "out_file.f32").read_bytes()
    b = (d / "out_vector.f32").read_bytes()
    check(len(a) == 4 * HP_FILE_SAMPLES and a == b,
          f"34 (d): the file run wrote {len(a)} bytes, the vector run {len(b)}, "
          f"{'equal' if a == b else 'different'}")
    print(f"phase 34 (d) FileSource -> TpuKernel(fir_fft, mag2) -> FileSink, "
          f"{HP_FILE_SAMPLES} complex64 samples: output files bit-equal to the "
          f"VectorSource run's ({len(a)} bytes; {times['file']:.2f} s from the file, "
          f"{times['vector']:.2f} s from the vector) [{card_line}]")
    for f in ("in.cf32", "out_file.f32", "out_vector.f32"):
        (d / f).unlink()
    return times


def phase_hostplane(dev, card_line, actor_runs: int = 1) -> dict:
    """Phase 34: (a) the north-star grid on the host, (b) its ``--tpu`` form
    on the card, (c) the apps, (d) a file through the card. The kernels'
    launches: ``fir`` over (b), ``fir_fft`` over (d)."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    grid = phase_hostplane_grid(card_line, actor_runs)
    ck.reset_launches()
    tpu = phase_hostplane_tpu(dev, card_line)
    torch.cuda.synchronize()
    launches = {"fir": ck.launches["fir"]}
    check(launches["fir"] > 0, "kernel fir was launched no time in phase 34 (b)")
    phase_hostplane_apps(card_line)
    ck.reset_launches()
    phase_hostplane_file(dev, card_line)
    torch.cuda.synchronize()
    launches["fir_fft"] = ck.launches["fir_fft"]
    check(launches["fir_fft"] > 0, "kernel fir_fft was launched no time in phase 34 (d)")
    print(f"phase 34: {time.perf_counter() - t0:.1f} s, launches fir {launches['fir']}, "
          f"fir_fft {launches['fir_fft']}")
    return {"launches": launches, "grid": grid, "tpu": tpu}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Chip smoke test of the port.")
    parser.add_argument("--stress", type=int, default=0, metavar="N",
                        help="only run the spectrum and FM streamed phases N "
                             "times each, each run under a stall watchdog")
    parser.add_argument("--serving", action="store_true",
                        help="only run phase 28, the serving plane, after the build")
    parser.add_argument("--models", action="store_true",
                        help="only run phase 29, the models' device plane, after the build")
    parser.add_argument("--sharded", action="store_true",
                        help="only run phase 30, the device axis, after the build")
    parser.add_argument("--telemetry", action="store_true",
                        help="only run phase 31, the telemetry plane, after the build")
    parser.add_argument("--multihost", action="store_true",
                        help="only run phase 32, the mesh across processes, the entry "
                             "points and LoRa, after the build")
    parser.add_argument("--protocols", action="store_true",
                        help="only run phase 33, the remaining models (M17's long frames "
                             "on the Viterbi kernel, the M17, ZigBee, ADS-B, Rattlegram and "
                             "CW apps), after the build")
    parser.add_argument("--hostplane", action="store_true",
                        help="only run phase 34, the host plane (the grid natively and "
                             "on each scheduler, its --tpu form, the apps, a file "
                             "through the card), after the build")
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)   # one rank process of phase 32
    parser.add_argument("--coordinator", default="", help=argparse.SUPPRESS)
    parser.add_argument("--rank-dir", default="", help=argparse.SUPPRESS)
    parser.add_argument("--ckpt-part", type=int, default=0, choices=(0, 1, 2),
                        help=argparse.SUPPRESS)   # one process of phase 26 (d)
    parser.add_argument("--ckpt-dir", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    stress_runs = args.stress
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a "
              "CUDA card", file=sys.stderr)
        return 2
    if args.ckpt_part:
        return ckpt_process(args.ckpt_part, args.ckpt_dir)
    if args.rank is not None:
        return rank_process(args.rank, args.coordinator, args.rank_dir)
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops import _build
    from futuresdr_tpu_torch.ops import cuda_kernels as ck

    # 1. the card
    card_line = card()
    print(card_line)
    dev = torch.device(DEVICE)

    # 2. build every kernel from the checkout's sources, nvcc runs in parallel
    t0 = time.perf_counter()
    empty_done = start_empty_kernel(_build.BUILD_DIR)
    paths = _build.build_all()
    empty_lib = empty_done()
    print(f"build: {time.perf_counter() - t0:.1f} s, "
          f"{', '.join(p.name for p in paths)} for sm_90a")
    # every streamed phase runs on the double-mapped circular buffer: its
    # library builds from csrc/host/ here, or the check fails (phase 21)
    from futuresdr_tpu_torch.runtime import default_buffer
    from futuresdr_tpu_torch.runtime.buffer import circular
    check(circular.available() and default_buffer() is circular.CircularWriter,
          "the circular buffer's library did not build: the streamed phases would run "
          "on the pure-Python ring")
    if stress_runs:
        stress(dev, stress_runs)
        return 0
    if args.serving:
        phase_serving(dev, firdes.lowpass(0.2, N_TAPS).astype(np.float32), card_line)
        return 0
    if args.models:
        phase_models(dev, card_line, empty_lib)
        return 0
    if args.sharded:
        phase_sharded(dev, card_line)
        return 0
    if args.telemetry:
        ck.reset_launches()
        phase_telemetry(dev, firdes.lowpass(0.2, N_TAPS).astype(np.float32), card_line)
        torch.cuda.synchronize()
        for k in TELE_KERNELS:
            check(ck.launches[k] > 0, f"kernel {k} was launched no time in phase 31")
        print("phase 31 launches: " + ", ".join(f"{k} {ck.launches[k]}" for k in TELE_KERNELS))
        return 0
    if args.multihost:
        phase_multihost(dev, card_line)
        return 0
    if args.protocols:
        phase_protocols(dev, card_line)
        return 0
    if args.hostplane:
        phase_hostplane(dev, card_line, actor_runs=3)
        return 0

    # 3, 9, 12. kernels against their plain versions
    worst = phase_kernels(dev, kernel_cases(dev) + fm_kernel_cases(dev)
                          + pfb_kernel_cases(dev))

    # 4-6. the spectrum chain, launch counts read over exactly these phases
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    taps2 = firdes.lowpass(0.05, N_TAPS).astype(np.float32)
    launches = {}
    by_phase = {}

    def path_phase(name, kernels, fn, *args):
        ck.reset_launches()
        result = fn(*args)
        torch.cuda.synchronize()
        by_phase[name] = {k: ck.launches[k] for k in kernels}
        for k in kernels:
            check(ck.launches[k] > 0, f"kernel {k} was launched no time in the {name} "
                                      f"phase of its path")
            launches[k] = launches.get(k, 0) + ck.launches[k]
        return result

    resident = path_phase("resident", SPECTRUM_KERNELS, phase_resident, dev, taps)
    streamed = path_phase("streamed", SPECTRUM_KERNELS, phase_streamed, dev, taps)
    path_phase("retune", SPECTRUM_KERNELS, phase_retune, dev, taps, taps2)

    # 10-11. the FM front end, its counts read over exactly its phases
    fm_resident = path_phase("fm_resident", FM_KERNELS, phase_fm_resident, dev)
    fm_streamed = path_phase("fm_streamed", FM_KERNELS, phase_fm_streamed, dev)
    path_phase("fm_retune", FM_KERNELS, phase_fm_retune, dev)
    phase_fm_kernel_count(dev)
    # the app as shipped reaches none of the kernels (xlating FIR on
    # matmuls, demod and resampler on their default routes)
    wav = _build.BUILD_DIR.parent / "fm_smoke.wav"
    phase_fm_wav(dev, wav)
    wav.unlink()

    # 13-14. the PFB channelizer, its counts read over exactly its phases
    pfb_resident = path_phase("pfb_resident", PFB_KERNELS, phase_pfb_resident, dev)
    pfb_streamed = path_phase("pfb_streamed", PFB_KERNELS, phase_pfb_streamed, dev)
    path_phase("pfb_retune", PFB_KERNELS, phase_pfb_retune, dev)
    # 15. the spectrum app (no hand kernel on its chain, as in the reference)
    spectrum_rate = phase_spectrum_app(dev)

    # 16-17. the host side: compiled replay against eager, retunes through
    #        the compiled carry, K = 4 streamed against K = 1
    all_kernels = SPECTRUM_KERNELS + FM_KERNELS + PFB_KERNELS
    compiled = path_phase("compiled", all_kernels, phase_compiled, dev, taps)
    path_phase("compiled_retune", all_kernels, phase_compiled_retune, dev, taps)
    megabatch = path_phase("megabatch", all_kernels, phase_megabatch_streamed, dev, taps)

    # 18. the message plane, and the handle on a streamed TpuKernel
    message = path_phase("message", ("fir_fft",), phase_message_plane, dev, taps, taps2)
    # 19. a ctrl retune over REST into the FM app's device chain (no hand
    #     kernel on the app's chain); 20. both apps' main() as subprocesses
    rest_wav = _build.BUILD_DIR.parent / "fm_rest.wav"
    rest_retune = phase_rest_retune(dev, rest_wav)
    rest_wav.unlink()
    main_wav = _build.BUILD_DIR.parent / "fm_main.wav"
    phase_app_mains(main_wav)
    main_wav.unlink()
    # 21. the circular buffer against the ring
    circ = path_phase("circular", ("fir_fft",) + FM_KERNELS, phase_circular, dev, taps)
    # 22-24. the device-frame plane and device-graph fusion, fused against
    #        per hop
    devchain = path_phase("devchain_linear", SPEC_KERNELS_22, phase_devchain_linear,
                          dev, taps)
    devchain.update(path_phase("devchain_fanout", FM_KERNELS, phase_devchain_fanout, dev))
    devchain.update(path_phase("devchain_dag", DAG_KERNELS, phase_devchain_dag, dev))
    # 25. the wires: codecs against their host twins, each wire streamed
    #     against the resident float32 chain with its link bytes, the frame
    #     plane, switches, zero-copy ingest, transfer faults, rates
    wires = path_phase("wires", ("fir_fft",) + FM_KERNELS, phase_wires, dev, taps)
    # 26. recovery: restart replays bit for bit on every chain, K and cadence,
    #     fused regions, checkpoints off, checkpoint_dir, isolate, rates
    recovery = path_phase("recovery", SPECTRUM_KERNELS + FM_KERNELS, phase_recovery,
                          dev, taps)
    # 27. precision and tuning: the A/B matrix, the int8 rungs, the plan
    #     sweep (all six kernels), the cache in the runtime, streamed retunes,
    #     the app's flags
    t27 = time.perf_counter()
    precision = path_phase("precision", SPECTRUM_KERNELS + FM_KERNELS + PFB_KERNELS,
                           phase_precision, dev, taps)
    print(f"phase 27: {time.perf_counter() - t27:.1f} s")
    # 28. the serving plane: the lane kernels, the main chain served at full
    #     width, serve_ab's chain under churn, the printed figures; the lane
    #     kernels' launches counted over the engines' runs alone
    serving = phase_serving(dev, taps, card_line)
    by_phase["serving"] = {k: serving["launches"][k] for k in LANE_KERNELS}
    for k in LANE_KERNELS:
        check(serving["launches"][k] > 0, f"lane kernel {k} was launched no time on the "
                                          f"served paths")
        launches[k] = serving["launches"][k]
    # 29. the models' device plane: the Viterbi kernel against its plain
    #     version, the demod, perf/wlan.py's stream and the loopback app on
    #     the card (the kernel's launches counted over those two), MCLDNN
    models = phase_models(dev, card_line, empty_lib)
    by_phase["models"] = {"viterbi": models["stream"]["launches"]}
    # 30. the device axis: training, the sharded streams, programs and engine,
    #     GPipe, checkpoints; the kernels' launches counted over its drives
    sharded = phase_sharded(dev, card_line)
    by_phase["sharded"] = {k: v for k, v in sharded["launches"].items() if v}
    for k, v in by_phase["sharded"].items():
        if k in launches:
            launches[k] += v
    # 31. the telemetry plane: the streamed, resident and served paths traced
    #     and profiled, the control port's routes and the doctor during a
    #     live run, the disabled hooks' cost; its kernels counted over it
    t31 = time.perf_counter()
    path_phase("telemetry", TELE_KERNELS, phase_telemetry, dev, taps, card_line)
    print(f"phase 31: {time.perf_counter() - t31:.1f} s")
    # 32. the mesh across processes (two rank processes on the card), the
    #     sharded train step, the entry points and LoRa; the fir launches of
    #     the ranks' drives and the dryrun's fir, fir_fft and pfb
    multihost = phase_multihost(dev, card_line)
    by_phase["multihost"] = dict(multihost["launches"])
    for k, v in multihost["launches"].items():
        launches[k] += v
    # 33. the remaining models: M17's long frames on the Viterbi kernel (its
    #     launches counted over the decode calls alone), the protocol apps
    protocols = phase_protocols(dev, card_line)
    by_phase["protocols"] = {"viterbi": protocols["launches"]}
    # 34. the host plane: the grid natively and on each scheduler, its --tpu
    #     form on the fir kernel, the apps, a file through the fir_fft chain;
    #     the kernels' launches counted over (b) and (d)
    hostplane = phase_hostplane(dev, card_line)
    by_phase["hostplane"] = dict(hostplane["launches"])
    for k, v in hostplane["launches"].items():
        launches[k] += v

    # 7. kernel timings at the streamed default frames, and the larger
    #    frames for the record
    timings = {f: kernel_timings(dev, f, taps) for f in FRAMES}
    fm_timings = {f: fm_kernel_timings(dev, f, empty_lib) for f in FM_FRAMES}
    pfb_t = {f: {"pfb": pfb_timings(dev, f)} for f in PFB_FRAMES}
    pfb_wide = {PFB_FRAMES[0]: {f"pfb/N={PFB_WIDE_N}": pfb_timings(dev, PFB_FRAMES[0],
                                                                 PFB_WIDE_N)}}
    rows = [(f, k, v) for f, t in timings.items() for k, v in t.items()]
    rows += [(f, k, v) for f, t in fm_timings.items() for k, v in t.items()]
    rows += [(f, k, v) for f, t in pfb_t.items() for k, v in t.items()]
    rows += [(f, k, v) for f, t in pfb_wide.items() for k, v in t.items()]
    rows += [(f, f"poly_fir/{c}", v) for f, t in fm_timings.items()
             for c, v in t["poly_fir"]["calls"].items()]
    rows += [(1 << 18, "poly_fir/decimator", decimator_timings(dev))]
    for f, k, v in rows:
        lib = "none" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
        before = EARLIER_MS.get((k, f))
        before = "" if before is None else f" (PERF.md before: {before:.4f} ms)"
        yard = "" if "copy_ms" not in v else (
            f", empty launch {v['empty_ms']:.4f} ms, copy of its bytes {v['copy_ms']:.4f} ms")
        print(f"timing {k} n={f}: kernel {v['ms']:.4f} ms{before}, plain "
              f"{v['plain_ms']:.4f} ms, library {lib}, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}){yard} [{card_line}]")
    # 27 (f). the roofline: the analytic bounds against PERF.md, the shares
    phase_roofline(rows)
    line = {"kernels": []}
    first = {**timings[FRAMES[0]], **fm_timings[FM_FRAMES[0]], **pfb_t[PFB_FRAMES[0]]}
    for k in SPECTRUM_KERNELS + FM_KERNELS + PFB_KERNELS:
        t = first[k]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": launches[k],
            "launches_by_phase": {p: c[k] for p, c in by_phase.items() if k in c},
            "max_abs_err": max(worst[k], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{y: t[y] for y in ("empty_ms", "copy_ms") if y in t}})
    for k in LANE_KERNELS:
        t = serving["timings"][(k, *LANE_LINE_SHAPE[k])]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": SOURCES[LANE_OF[k]],
            "replaces": REPLACES[LANE_OF[k]], "launches": launches[k],
            "launches_by_phase": {p: c[k] for p, c in by_phase.items() if k in c},
            "lanes": LANE_LINE_SHAPE[k][0], "n": LANE_LINE_SHAPE[k][1],
            "max_abs_err": max(serving["worst"][k], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{y: t[y] for y in ("copy_ms",) if y in t}})
    t = models["viterbi"]
    line["kernels"].append({
        "name": "viterbi", "route": "cuda", "source": SOURCE_VITERBI,
        "replaces": REPLACES_VITERBI,
        "launches": models["stream"]["launches"] + protocols["launches"],
        "launches_by_phase": {"models": models["stream"]["launches"],
                              "protocols": protocols["launches"]},
        "batch": VIT_LINE[0], "steps": VIT_LINE[1], "states": 64,
        **{y: t[y] for y in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "seq_floor_ms", "one_frame_ms", "acs_ms",
                             "generic_ms", "states16_ms")},
        "m17_frame_us": {str(n): r["call_us"]
                         for n, r in protocols["viterbi"]["frames"].items()},
        "m17_frame_kernel_ms": {str(n): r["kernel_ms"]
                                for n, r in protocols["viterbi"]["frames"].items()},
        "m17_frame_plain_ms": {str(n): r["plain_ms"]
                               for n, r in protocols["viterbi"]["frames"].items()}})
    print(json.dumps(line))

    # 8. rates beside the card
    for route in ROUTES:
        for f in FRAMES:
            print(f"rate {route} resident frame={f}: {resident[(route, f)]:.1f} Msamples/s "
                  f"[{card_line}]")
        print(f"rate {route} streamed frame={FRAMES[0]} in-flight={IN_FLIGHT} "
              f"(median of {STREAM_RUNS}): {streamed[route]:.1f} Msamples/s [{card_line}]")
    for chain in FM_CHAINS:
        for f in FM_FRAMES:
            print(f"rate fm {chain} resident frame={f}: {fm_resident[(chain, f)]:.1f} "
                  f"input Msamples/s [{card_line}]")
        if chain in fm_streamed:
            print(f"rate fm {chain} streamed frame={FM_FRAMES[0]} in-flight={IN_FLIGHT} "
                  f"(median of {STREAM_RUNS}): {fm_streamed[chain]:.1f} input "
                  f"Msamples/s [{card_line}]")
    for impl in PFB_IMPLS:
        for f in PFB_FRAMES:
            print(f"rate pfb {impl} resident frame={f}: {pfb_resident[(impl, f)]:.1f} "
                  f"input Msamples/s [{card_line}]")
    print(f"rate pfb pallas streamed frame={PFB_FRAMES[0]} in-flight={IN_FLIGHT} "
          f"(median of {STREAM_RUNS}): {pfb_streamed:.1f} input Msamples/s [{card_line}]")
    print(f"rate spectrum app streamed (FFT_SIZE 2048, frame 32768): "
          f"{spectrum_rate:.1f} input Msamples/s [{card_line}]")
    for (label, f), modes in compiled.items():
        print(f"rate {label} resident frame={f}: " + ", ".join(
            f"{m} {msps:.1f} Msamples/s (card {us:.1f} us a frame)"
            for m, (msps, us) in modes.items()) + f" [{card_line}]")
    for (label, f, k), msps in megabatch.items():
        print(f"rate {label} streamed frame={f} in-flight={IN_FLIGHT} K={k} (median of "
              f"{STREAM_RUNS}): {msps:.1f} input Msamples/s [{card_line}]")
    for (label, f, k, buf), msps in circ.items():
        print(f"rate {label} streamed frame={f} in-flight={IN_FLIGHT} K={k} buffer={buf} "
              f"(median of {STREAM_RUNS}): {msps:.1f} input Msamples/s [{card_line}]")
    for label, modes in devchain.items():
        for (fused, k), (msps, disp, h2d, d2h) in sorted(modes.items()):
            print(f"rate devchain {label} K={k} {'fused' if fused else 'per hop'} "
                  f"(median of {STREAM_RUNS}): {msps:.1f} input Msamples/s, {disp:g} "
                  f"dispatches a frame, H2D {h2d:.0f} B, D2H {d2h:.0f} B a frame "
                  f"[{card_line}]")
    from futuresdr_tpu_torch.ops.wire import measure_snr_db
    for (name, k), msps in wires["rates"].items():
        print(f"rate wire {name} spectrum fused streamed frame={FRAMES[0]} "
              f"in-flight={IN_FLIGHT} K={k} (median of {STREAM_RUNS}): {msps:.1f} input "
              f"Msamples/s, codec SNR {measure_snr_db(name):.1f} dB [{card_line}]")
    for (k, ck), (msps, peak) in sorted(recovery["rates"].items()):
        print(f"rate recovery spectrum fused streamed frame={FRAMES[0]} in-flight="
              f"{IN_FLIGHT} K={k} checkpoint cadence {ck} (median of {STREAM_RUNS}): "
              f"{msps:.1f} input Msamples/s, arena peak pinned {peak} B [{card_line}]")
    for (chain, k, ck, fault), dt in recovery["to_first"].items():
        print(f"recovery time {chain} K={k} cadence {ck} {fault}: {dt * 1e3:.3f} ms from "
              f"recover() to the first replayed output [{card_line}]")
    for (label, mode), row in precision["ab"].items():
        print(f"rate precision {label} {mode} resident frame={FRAMES[0]}: "
              f"{row['msps']:.1f} Msamples/s (card {row['us']:.2f} us a frame), "
              f"{row['snr']:.2f} dB against f32 [{card_line}]")
    for k, (msps, snr) in precision["streamed"].items():
        print(f"rate precision spectrum auto streamed frame={FRAMES[0]} K={k}: "
              f"{msps:.1f} input Msamples/s, {snr:.2f} dB against f32 [{card_line}]")
    print(f"rest: ctrl retune round trip {rest_retune['rtt_ms']:.3f} ms, "
          f"{rest_retune['frames']} frames from the POST to the first retuned frame; "
          f"handle ctrl call {message['call_ms']:.3f} ms, metrics "
          f"{message['metrics_ms']:.3f} ms [{card_line}]")
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
