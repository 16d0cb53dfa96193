"""The port's entry points: the MCLDNN forward, and a dry run of every
sharded form over n devices.

The counterpart of the repository root's ``__graft_entry__.py``:

* :func:`entry` returns the MCLDNN modulation classifier's forward at the
  reference's widths (``MCLDNN()``, windows of 128) and an ``[8, 2, 128]``
  batch made from seed 0;
* :func:`dryrun_multichip` runs the reference's dryrun step by step, in its
  order, over ``n`` devices (the cards where there are that many, else config
  ``virtual_devices = n`` logical devices on card 0, or on the CPU when
  ``device="cpu"`` asks for it): the sharded ``(dp, mp)`` train step, the
  sequence-parallel spectrum chain and stateful FIR, a LoRa preamble scan over
  a capture the port's modulator makes, the all-to-all channelizer, the mesh
  flowgraph against one device, GPipe alone and in a flowgraph, the composed
  ``(pp, sp)`` mesh with a checkpoint mid-stream (the resumed run bit-equal
  to the whole one) and, on multiples of 4, the composed ``(dp, pp, sp)``
  mesh whose streamed output trains MCLDNN on the same mesh. The reference's
  asserts hold at its tolerances; a failed one raises.

Both run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def _device(device) -> torch.device:
    from .tpu.instance import resolve_device
    return resolve_device(device)


def entry(device=None):
    """``(forward, (model, batch))``: ``forward(model, batch)`` gives the
    ``[8, 11]`` logits of MCLDNN at its default widths (weights from seed 0)
    on ``device`` (None: the card)."""
    from .models.mcldnn import MCLDNN, init_params

    dev = _device(device)
    model = init_params(MCLDNN(), torch.Generator().manual_seed(0)).to(dev).eval()
    batch = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 2, 128))
                             .astype(np.float32)).to(dev)

    def forward(model, iq):
        with torch.no_grad():
            return model(iq)

    return forward, (model, batch)


def _devices(n: int, dev: torch.device) -> list:
    """``n`` devices: the cards when there are that many, else ``n`` logical
    devices on ``dev`` (config ``virtual_devices``, set by the caller)."""
    from .parallel import visible_devices
    devs = visible_devices(dev)
    if len(devs) < n:
        raise RuntimeError(f"need {n} devices, have {len(devs)} ({dev.type})")
    return devs[:n]


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The reference's ``dryrun_multichip`` on the port (module docstring);
    raises where it cannot have ``n_devices`` devices or an assert fails."""
    from .config import config

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"need at least one device, asked for {n}")
    dev = _device(device)
    cfg = config()
    prev = cfg.virtual_devices
    if dev.type != "cuda" or torch.cuda.device_count() < n:
        cfg.virtual_devices = n
    else:
        cfg.virtual_devices = 0
    try:
        _dryrun(n, _devices(n, dev))
    finally:
        cfg.virtual_devices = prev


def _tanh_stage(w, a):
    return torch.tanh(a @ w)


def _host_stages(x: np.ndarray, W: np.ndarray, micro_b: int, d: int) -> np.ndarray:
    ref = x.reshape(-1, micro_b, d)
    for s in range(W.shape[0]):
        ref = np.tanh(ref @ W[s])
    return ref.reshape(-1)


def _stream_one_device(taps, data, frame: int, n_frames: int, devices, fft_size=None):
    """The stateful chain on a one-device mesh, frame by frame (the
    reference's single-device check)."""
    from .parallel import make_mesh, sp_fir_fft_mag2_stream, sp_fir_stream, to_host
    mesh1 = make_mesh(("sp",), shape=(1,), devices=devices[:1])
    if fft_size is None:
        fn, init = sp_fir_stream(taps, mesh1)
    else:
        fn, init = sp_fir_fft_mag2_stream(taps, fft_size, mesh1)
    carry = init(np.float32)
    out = []
    for k in range(n_frames):
        carry, y = fn(carry, data[k * frame:(k + 1) * frame])
        out.append(to_host(y))
    return np.concatenate(out)


def _run_fg(*blocks):
    from .runtime import Flowgraph, Runtime
    fg = Flowgraph()
    fg.connect(*blocks)
    Runtime().run(fg)


def _dryrun(n_devices: int, devices: list) -> None:
    from .blocks import VectorSink, VectorSource, pfb_default_taps
    from .models.lora.phy import LoraParams, modulate_frame
    from .models.mcldnn import MCLDNN, init_params, loss_fn
    from .parallel import (make_mesh, make_pp_pipeline, sp_channelizer_a2a,
                           sp_dechirp_scan, sp_fir_fft_mag2, sp_fir_fft_mag2_stream,
                           sp_fir_stream, to_host)
    from .parallel.sharded_train import ShardedTrainStep
    from .tpu import PpKernel, SpKernel
    from .utils.checkpoint import load_flowgraph_state, save_flowgraph_state

    # ---- sharded training step: dp × mp ------------------------------------
    mesh = make_mesh(("dp", "mp"), devices=devices)
    model = init_params(MCLDNN(n_classes=11, conv_features=8, lstm_features=16),
                        torch.Generator().manual_seed(0))
    step = ShardedTrainStep(model, mesh, loss_fn, "dp", "mp")
    b = 2 * mesh.shape["dp"]
    iq = torch.from_numpy(np.random.default_rng(0).standard_normal((b, 2, 64))
                          .astype(np.float32))
    loss, _acc = step(iq, torch.zeros(b, dtype=torch.int64))
    assert np.isfinite(float(loss)), "train step produced non-finite loss"

    # ---- sequence-parallel stream pipeline over all devices ------------------
    sp_mesh = make_mesh(("sp",), shape=(n_devices,), devices=devices)
    taps = np.hanning(64).astype(np.float32)
    fft_size = 128
    n = n_devices * 4 * fft_size
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y = to_host(sp_fir_fft_mag2(taps, fft_size, sp_mesh)(x))
    assert y.shape == (n,), y.shape
    assert np.isfinite(y).all()

    # ---- cross-frame-stateful sharded streaming (carry chained, 2 frames) ----
    sfn, init_carry = sp_fir_stream(taps, sp_mesh)
    carry = init_carry(np.float32)
    carry, _y1 = sfn(carry, x)
    carry, y2 = sfn(carry, x)          # frame 2 takes frame 1's tail as its halo
    assert np.isfinite(to_host(y2)).all()

    # ---- sequence-parallel LoRa preamble scan over a modulated capture ------
    sf = 7
    if n // n_devices >= (1 << sf):
        capture = (0.1 * x).astype(np.complex64)
        frame = modulate_frame(b"dryrun", LoraParams(sf=sf))[:n - 256]
        capture[256:256 + len(frame)] += frame
        bins, conc = sp_dechirp_scan(sf, sp_mesh)(capture)
        bins, conc = to_host(bins), to_host(conc)
        assert bins.shape == conc.shape and np.isfinite(conc).all()
        assert conc.max() > 0.9, f"the preamble was not found (concentration {conc.max()})"

    # ---- all-to-all (Ulysses-style) channel resharding -----------------------
    n_chan = 8
    if n_chan % n_devices == 0:
        xc = (np.random.default_rng(2).standard_normal(n_devices * 16 * n_chan)
              + 0j).astype(np.complex64)
        yc = to_host(sp_channelizer_a2a(n_chan, pfb_default_taps(n_chan), sp_mesh)(xc))
        assert yc.shape[0] == n_chan

    # ---- mesh flowgraph: the runtime driving the sharded compute plane -------
    fg_frame = n_devices * 2 * fft_size
    data = np.random.default_rng(5).standard_normal(3 * fg_frame).astype(np.float32)
    fn_s, init_c = sp_fir_fft_mag2_stream(taps, fft_size, sp_mesh)
    snk = VectorSink(np.float32)
    _run_fg(VectorSource(data), SpKernel(fn_s, sp_mesh, np.float32, np.float32, fg_frame,
                                         init_carry=init_c), snk)
    got = np.asarray(snk.items())
    assert got.shape == (3 * fg_frame,), got.shape
    ref = _stream_one_device(taps, data, fg_frame, 3, devices, fft_size)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    # ---- pipeline parallelism: GPipe microbatched stages over pp ------------
    pp_stages = min(4, n_devices)
    if pp_stages >= 2:                 # pp runs on a device subset
        pp_mesh = make_mesh(("pp",), shape=(pp_stages,), devices=devices[:pp_stages])
        d = 16
        W = (np.random.default_rng(3).standard_normal((pp_stages, d, d))
             .astype(np.float32) / 4.0)
        xm = torch.from_numpy(np.random.default_rng(4).standard_normal((5, 2, d))
                              .astype(np.float32))
        ym = make_pp_pipeline(_tanh_stage, pp_stages, 5, pp_mesh)(torch.from_numpy(W), xm)
        assert ym.shape == xm.shape and torch.isfinite(ym).all()

        # the same pipeline through the runtime, against the stages on the host
        n_micro, micro_b = 5, 2
        frame_items = n_micro * micro_b * d
        pdata = np.random.default_rng(6).standard_normal(2 * frame_items).astype(np.float32)
        psnk = VectorSink(np.float32)
        _run_fg(VectorSource(pdata),
                PpKernel(_tanh_stage, W, pp_mesh, np.float32, np.float32,
                         micro_shape=(micro_b, d), n_micro=n_micro, wire="f32"), psnk)
        np.testing.assert_allclose(np.asarray(psnk.items()),
                                   _host_stages(pdata, W, micro_b, d), rtol=2e-5, atol=2e-5)

    # ---- composed 2D (pp, sp) mesh with a checkpoint mid-stream --------------
    if n_devices >= 4 and n_devices % 2 == 0:
        pp_n, sp_n = 2, n_devices // 2
        mesh2 = make_mesh(("pp", "sp"), shape=(pp_n, sp_n), devices=devices)
        d2, micro_b2 = 16, 2
        F = 128 * sp_n                 # divisible by sp_n and 32
        n_micro2 = F // (micro_b2 * d2)
        taps2 = np.hanning(48).astype(np.float32)
        W2 = np.random.default_rng(8).standard_normal((pp_n, d2, d2)).astype(np.float32) / 4
        data2 = np.random.default_rng(9).standard_normal(4 * F).astype(np.float32)

        def build_fg(n_frames=4, offset=0):
            from .runtime import Flowgraph
            fn2, initc2 = sp_fir_stream(taps2, mesh2)      # shards sp, replicates pp
            fg2, snk2 = Flowgraph(), VectorSink(np.float32)
            fg2.connect(VectorSource(data2[offset:offset + n_frames * F]),
                        SpKernel(fn2, mesh2, np.float32, np.float32, F, init_carry=initc2),
                        PpKernel(_tanh_stage, W2, mesh2, np.float32, np.float32,
                                 micro_shape=(micro_b2, d2), n_micro=n_micro2, axis="pp",
                                 frames_in_flight=1, wire="f32"), snk2)
            return fg2, snk2

        from .runtime import Runtime
        fg_a, snk_a = build_fg()
        Runtime().run(fg_a)
        full = np.asarray(snk_a.items())
        assert full.shape == (4 * F,), full.shape
        # interrupted: 2 frames, the state saved, fresh blocks restore it and
        # finish the other 2
        fg_b, snk_b = build_fg(n_frames=2)
        Runtime().run(fg_b)
        with tempfile.TemporaryDirectory() as td:
            save_flowgraph_state(fg_b, f"{td}/carry")
            fg_c, snk_c = build_fg(n_frames=2, offset=2 * F)
            assert load_flowgraph_state(fg_c, f"{td}/carry") >= 1, "no state restored"
        Runtime().run(fg_c)
        resumed = np.concatenate([np.asarray(snk_b.items()), np.asarray(snk_c.items())])
        np.testing.assert_array_equal(resumed, full)
        ref2 = _stream_one_device(taps2, data2, F, 4, devices)
        np.testing.assert_allclose(full, _host_stages(ref2, W2, micro_b2, d2),
                                   rtol=1e-4, atol=1e-4)

    # ---- composed 3D (dp, pp, sp) mesh: the stream plane feeds training ------
    if n_devices >= 4 and n_devices % 4 == 0:
        mesh3 = make_mesh(("dp", "pp", "sp"), shape=(2, 2, n_devices // 4),
                          devices=devices)
        sp3 = mesh3.shape["sp"]
        d3, micro_b3 = 16, 2
        F3 = 128 * max(sp3, 1)
        taps3 = np.hanning(32).astype(np.float32)
        W3 = np.random.default_rng(10).standard_normal((2, d3, d3)).astype(np.float32) / 4
        data3 = np.random.default_rng(11).standard_normal(2 * F3).astype(np.float32)
        fn3, initc3 = sp_fir_stream(taps3, mesh3)          # shards sp, replicates dp/pp
        snk3 = VectorSink(np.float32)
        _run_fg(VectorSource(data3),
                SpKernel(fn3, mesh3, np.float32, np.float32, F3, init_carry=initc3),
                PpKernel(_tanh_stage, W3, mesh3, np.float32, np.float32,
                         micro_shape=(micro_b3, d3), n_micro=F3 // (micro_b3 * d3),
                         axis="pp", frames_in_flight=1, wire="f32"), snk3)
        got3 = np.asarray(snk3.items())
        assert got3.shape == (2 * F3,), got3.shape
        ref3 = _stream_one_device(taps3, data3, F3, 2, devices)
        np.testing.assert_allclose(got3, _host_stages(ref3, W3, micro_b3, d3),
                                   rtol=1e-4, atol=1e-4)

        # the streamed output is the training batch on the same mesh: batches
        # data-parallel over dp, weights sharded along pp
        b3 = 2 * mesh3.shape["dp"]
        L3 = min(64, got3.size // (b3 * 2))               # sp = 1 streams fewer
        iq3 = torch.from_numpy(got3[:b3 * 2 * L3].reshape(b3, 2, L3).astype(np.float32))
        model3 = init_params(MCLDNN(n_classes=11, conv_features=8, lstm_features=16),
                             torch.Generator().manual_seed(0))
        step3 = ShardedTrainStep(model3, mesh3, loss_fn, "dp", "pp")
        loss3, _ = step3(iq3, torch.zeros(b3, dtype=torch.int64))
        assert np.isfinite(float(loss3)), "3D-mesh train step non-finite"
