"""The port's multi-device stream plane (``futuresdr_tpu_torch/parallel``,
``tpu/sp_block.py``, ``tpu/pp_block.py``) against the JAX package on the CPU.

The port's mesh here is config ``virtual_devices`` = 8 logical CPU devices;
the JAX side runs on the 8 virtual CPU devices ``tests/conftest.py`` provides,
each program jitted once a shape. The same numpy inputs, made from a seed, go
through both; every ``sp_*`` function is held at 1e-4 (the reference's own bar,
``tests/test_parallel.py``), the stream forms across frame boundaries. On the
CPU the port's shards run the kernels' plain versions (``fir_continue``,
``fir_fft``, ``pfb``). Every cross-shard transfer the port makes is counted on
its mesh, and the tests read those counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from futuresdr_tpu import parallel as jpar
from futuresdr_tpu.blocks.pfb import pfb_default_taps
from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.parallel import (factor_devices, make_mesh, make_pp_pipeline,
                                          place, shard_params, sp_channelizer,
                                          sp_channelizer_a2a, sp_dechirp_scan, sp_fir,
                                          sp_fir_fft_mag2, sp_fir_fft_mag2_stream,
                                          sp_fir_stream, to_host)
from futuresdr_tpu_torch.tpu import PpKernel, SpKernel

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-4
D = 8


@pytest.fixture(autouse=True)
def logical_devices():
    """8 logical CPU devices for the port's meshes, as conftest gives JAX 8."""
    cfg = config()
    prev = cfg.virtual_devices
    cfg.virtual_devices = D
    yield
    cfg.virtual_devices = prev


def _mesh(n=D, axes=("sp",)):
    return make_mesh(axes, shape=(n,) if len(axes) == 1 else None, device="cpu")


def _jmesh(n=D, axis="sp"):
    return jpar.make_mesh((axis,), shape=(n,), devices=jax.devices()[:n])


def _jput(x, mesh, axis="sp"):
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def _c64(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


def test_factor_devices_matches_the_reference():
    for n in range(1, 65):
        for n_axes in (1, 2, 3, 4):
            assert factor_devices(n, n_axes) == jpar.factor_devices(n, n_axes), (n, n_axes)
    for bad in ((0, 2), (8, 0)):
        with pytest.raises(ValueError):
            factor_devices(*bad)


def test_make_mesh_refuses_a_short_mesh():
    with pytest.raises(ValueError, match="refusing"):
        make_mesh(("a", "b"), shape=(D, 2), device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        make_mesh(("a",), shape=(1, 1), device="cpu")
    m = make_mesh(("sp",), shape=(1,), device="cpu")      # an explicit sub-mesh
    assert m.shape["sp"] == 1
    assert make_mesh(("dp", "mp"), device="cpu").shape == {"dp": 4, "mp": 2}
    config().virtual_devices = 0                          # off: the CPU is one device
    with pytest.raises(ValueError, match="refusing"):
        make_mesh(("sp",), shape=(2,), device="cpu")


def test_sp_fir_matches_jax():
    taps = np.hanning(63).astype(np.float32)
    x = np.random.default_rng(0).standard_normal(D * 512).astype(np.float32)
    mesh = _mesh()
    got = to_host(sp_fir(taps, mesh)(x))
    jm = _jmesh()
    want = jax.jit(jpar.sp_fir(taps, jm))(_jput(x, jm))
    _close(got, want)
    assert mesh.transfers["ppermute"] == D - 1         # one halo a shard edge
    assert mesh.transfer_bytes == (D - 1) * 62 * 4


@pytest.mark.parametrize("trial", range(3))
def test_sp_fir_random_shapes_match_jax(trial):
    rng = np.random.default_rng(808 + trial)
    nt = int(rng.integers(2, 97))
    per = int(rng.integers(max(nt, 64), 512))
    taps = rng.standard_normal(nt).astype(np.float32)
    x = _c64(rng, D * per) if trial % 2 else rng.standard_normal(D * per).astype(np.float32)
    got = to_host(sp_fir(taps, _mesh())(x))
    jm = _jmesh()
    want = jax.jit(jpar.sp_fir(taps, jm))(_jput(x, jm))
    _close(got, want)


def test_sp_fir_fft_mag2_matches_jax():
    taps = np.hanning(64).astype(np.float32)
    fft = 128
    x = _c64(np.random.default_rng(1), D * 4 * fft)
    got = to_host(sp_fir_fft_mag2(taps, fft, _mesh())(x))
    jm = _jmesh()
    want = jax.jit(jpar.sp_fir_fft_mag2(taps, fft, jm))(_jput(x, jm))
    _close(got, want)


def _jax_stream(fn, init_carry, frames, jm, dtype):
    jfn = jax.jit(fn)
    carry = init_carry(dtype)
    out = []
    for f in frames:
        carry, y = jfn(carry, _jput(f, jm))
        out.append(np.asarray(y))
    return np.concatenate(out)


def test_sp_fir_stream_matches_jax_across_frames():
    taps = np.hanning(31).astype(np.float32)
    rng = np.random.default_rng(5)
    frames = [_c64(rng, D * 256) for _ in range(4)]
    mesh = _mesh()
    fn, init = sp_fir_stream(taps, mesh)
    carry = init(np.complex64)
    got = []
    for f in frames:
        carry, y = fn(carry, f)
        got.append(to_host(y))
    got = np.concatenate(got)
    jm = _jmesh()
    want = _jax_stream(*jpar.sp_fir_stream(taps, jm), frames, jm, np.complex64)
    _close(got, want)
    edge = slice(D * 256 - 16, D * 256 + 16)            # the first frame edge
    _close(got[edge], want[edge])
    # halos a frame plus the carry from the last shard to the first
    assert mesh.transfers["ppermute"] == 4 * D


def test_sp_fir_fft_mag2_stream_matches_jax_across_frames():
    taps = np.hanning(64).astype(np.float32)
    fft = 128
    rng = np.random.default_rng(6)
    frames = [_c64(rng, D * 2 * fft) for _ in range(3)]
    fn, init = sp_fir_fft_mag2_stream(taps, fft, _mesh())
    carry = init(np.complex64)
    got = []
    for f in frames:
        carry, y = fn(carry, f)
        got.append(to_host(y))
    jm = _jmesh()
    want = _jax_stream(*jpar.sp_fir_fft_mag2_stream(taps, fft, jm), frames, jm,
                       np.complex64)
    _close(np.concatenate(got), want)


def test_stream_per_shard_length_check_raises_like_jax():
    taps = np.hanning(65).astype(np.float32)
    x = np.zeros(D * 32, np.float32)                    # 32 < 64-sample halo
    fn, init = sp_fir_stream(taps, _mesh())
    with pytest.raises(ValueError, match="per-shard length 32 < halo 64"):
        fn(init(np.float32), x)
    jm = _jmesh()
    jfn, jinit = jpar.sp_fir_stream(taps, jm)
    with pytest.raises(ValueError, match="per-shard length 32 < halo 64"):
        jax.jit(jfn)(jinit(np.float32), _jput(x, jm))


def test_sp_channelizer_matches_jax_and_routes_a_tone():
    N = 8
    n = D * 32 * N
    c = 3
    x = np.exp(1j * 2 * np.pi * (c / N) * np.arange(n)).astype(np.complex64)
    x += 0.01 * _c64(np.random.default_rng(9), n)
    taps = pfb_default_taps(N)
    got = to_host(sp_channelizer(N, taps, _mesh())(x))
    assert got.shape == (N, n // N)
    jm = _jmesh()
    want = np.asarray(jax.jit(jpar.sp_channelizer(N, taps, jm))(_jput(x, jm)))
    _close(got, want)
    powers = (np.abs(got[:, 32:]) ** 2).mean(axis=1)
    assert np.argmax(powers) == c


def test_sp_channelizer_a2a_matches_jax_and_the_ring_form():
    N = 8
    n = D * 32 * N
    x = _c64(np.random.default_rng(10), n)
    taps = pfb_default_taps(N)
    mesh = _mesh()
    ring = sp_channelizer(N, taps, mesh)(x)
    a2a = sp_channelizer_a2a(N, taps, mesh)(x)
    assert a2a.dim == 0 and a2a.shards[0].shape == (N // D, n // N)
    got = to_host(a2a)
    np.testing.assert_array_equal(got, to_host(ring))
    jm = _jmesh()
    want = np.asarray(jax.jit(jpar.sp_channelizer_a2a(N, taps, jm))(_jput(x, jm)))
    _close(got, want)
    assert mesh.transfers["all_to_all"] == D * (D - 1)


def test_sp_dechirp_scan_matches_jax():
    from futuresdr_tpu.models.lora.phy import LoraParams, modulate_frame
    sf, hop = 7, 32
    p = LoraParams(sf=sf, cr=2)
    rng = np.random.default_rng(3)
    sig = np.concatenate([np.zeros(777, np.complex64), modulate_frame(b"spscan", p)])
    total = D * 1024
    x = np.zeros(total, np.complex64)
    x[:len(sig)] = sig[:total]
    x = (x + 0.02 * _c64(rng, total)).astype(np.complex64)
    bins, conc = sp_dechirp_scan(sf, _mesh(), hop)(x)
    jm = _jmesh()
    jb, jc = jax.jit(jpar.sp_dechirp_scan(sf, jm, hop))(_jput(x, jm))
    np.testing.assert_array_equal(to_host(bins), np.asarray(jb))
    np.testing.assert_allclose(to_host(conc), np.asarray(jc), atol=1e-5)


def test_pp_pipeline_matches_jax():
    n_stages, n_micro, mb, d = 4, 6, 3, 16
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((n_stages, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    mesh = make_mesh(("pp",), shape=(n_stages,), device="cpu")
    got = make_pp_pipeline(lambda w, a: torch.tanh(a @ w), n_stages, n_micro, mesh)(
        torch.from_numpy(W), torch.from_numpy(x)).numpy()
    jm = jpar.make_mesh(("pp",), shape=(n_stages,), devices=jax.devices()[:n_stages])
    want = jax.jit(jpar.make_pp_pipeline(lambda w, a: jnp.tanh(a @ w), n_stages, n_micro,
                                         jm))(jax.device_put(W, NamedSharding(jm, P("pp"))),
                                              x)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    # (n_stages - 1) hops a microbatch, and each output back to stage 0
    assert mesh.transfers["ppermute"] == n_micro * (n_stages - 1)
    assert mesh.transfers["psum"] == n_micro


def test_pp_pipeline_full_mesh_complex():
    n_stages, n_micro, d = D, 5, 8
    rng = np.random.default_rng(1)
    W = _c64(rng, n_stages * d * d).reshape(n_stages, d, d)
    x = _c64(rng, n_micro * d).reshape(n_micro, d)
    mesh = make_mesh(("pp",), shape=(n_stages,), device="cpu")
    got = make_pp_pipeline(lambda w, a: a @ w / d, n_stages, n_micro, mesh)(
        torch.from_numpy(W), torch.from_numpy(x)).numpy()
    ref = x
    for s in range(n_stages):
        ref = ref @ W[s] / d
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)


def test_shard_params_specs_match_jax():
    shapes = {"conv": (16, 1, 2, 8), "dense": (64, 128), "bias": (128,), "odd": (3, 5),
              "scalar": ()}
    rng = np.random.default_rng(2)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    mesh = make_mesh(("dp", "mp"), shape=(2, 4), device="cpu")
    sharded, specs = shard_params({k: torch.from_numpy(v) for k, v in params.items()},
                                  mesh, axis="mp")
    jm = jpar.make_mesh(("dp", "mp"), shape=(2, 4))
    _jsh, jspecs = jpar.shard_params(params, jm, axis="mp")
    for k in shapes:
        want = tuple(jspecs[k].spec)
        want = want + (None,) * (len(shapes[k]) - len(want))
        assert specs[k] == want, (k, specs[k], want)
    for k, v in params.items():
        got = sharded[k]
        back = torch.cat(got.shards, dim=got.dim) if k in ("conv", "dense", "bias") \
            else got[0]
        np.testing.assert_array_equal(back.numpy(), v)


def _run_fg(*blocks):
    fg = Flowgraph()
    fg.connect(*blocks)
    Runtime().run(fg)


def test_sp_kernel_flowgraph_matches_jax_sp_kernel():
    from futuresdr_tpu import Flowgraph as JFlowgraph, Runtime as JRuntime
    from futuresdr_tpu.blocks import VectorSink as JSink, VectorSource as JSource
    from futuresdr_tpu.tpu import SpKernel as JSpKernel
    taps = np.hanning(64).astype(np.float32)
    fft = 128
    frame = D * 4 * fft
    data = _c64(np.random.default_rng(3), 3 * frame)
    snk = VectorSink(np.float32)
    _run_fg(VectorSource(data), SpKernel(sp_fir_fft_mag2(taps, fft, _mesh()), _mesh(),
                                         np.complex64, np.float32, frame), snk)
    jm = _jmesh()
    jfg, jsnk = JFlowgraph(), JSink(np.float32)
    jfg.connect(JSource(data), JSpKernel(jpar.sp_fir_fft_mag2(taps, fft, jm), jm,
                                         np.complex64, np.float32, frame), jsnk)
    JRuntime().run(jfg)
    assert len(snk.items()) == 3 * frame
    _close(np.asarray(snk.items()), np.asarray(jsnk.items()))


def test_sp_kernel_stateful_drops_the_partial_tail():
    from scipy import signal as sps
    taps = np.hanning(33).astype(np.float32)
    frame = D * 256
    data = _c64(np.random.default_rng(9), 4 * frame + 100)
    mesh = _mesh()
    fn, init = sp_fir_stream(taps, mesh)
    snk = VectorSink(np.complex64)
    _run_fg(VectorSource(data), SpKernel(fn, mesh, np.complex64, np.complex64, frame,
                                         init_carry=init), snk)
    got = np.asarray(snk.items())
    assert len(got) == 4 * frame                       # the 100-sample tail is dropped
    _close(got, sps.lfilter(taps, 1.0, data[:4 * frame]), 1e-3)


def test_pp_kernel_flowgraph_update_params_and_refusals():
    n_stages, d, mb, n_micro = 4, 8, 3, 5
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((n_stages, d, d)) / 4.0).astype(np.float32)
    mesh = make_mesh(("pp",), shape=(n_stages,), device="cpu")
    items = n_micro * mb * d
    data = rng.standard_normal(3 * items).astype(np.float32)

    def stage(w, a):
        return torch.tanh(a @ w)

    snk = VectorSink(np.float32)
    _run_fg(VectorSource(data), PpKernel(stage, W, mesh, np.float32, np.float32,
                                         micro_shape=(mb, d), n_micro=n_micro), snk)
    ref = data.reshape(-1, mb, d)
    for s in range(n_stages):
        ref = np.tanh(ref @ W[s])
    np.testing.assert_allclose(np.asarray(snk.items()), ref.reshape(-1), rtol=2e-5, atol=2e-5)
    ppk = PpKernel(stage, W, mesh, np.float32, np.float32, micro_shape=(mb, d),
                   n_micro=n_micro)
    ppk.update_params(W * 0.5)
    snk2 = VectorSink(np.float32)
    _run_fg(VectorSource(data[:items]), ppk, snk2)
    ref2 = data[:items].reshape(-1, mb, d)
    for s in range(n_stages):
        ref2 = np.tanh(ref2 @ (W[s] * 0.5))
    np.testing.assert_allclose(np.asarray(snk2.items()), ref2.reshape(-1), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="n_stages"):
        PpKernel(stage, W[:2], mesh, np.float32, np.float32, micro_shape=(mb, d),
                 n_micro=n_micro)
    with pytest.raises(ValueError, match="n_stages"):
        ppk.update_params(np.concatenate([W, W]))


def test_pp_kernel_partial_tail_zero_padded():
    n_stages, d, mb, n_micro = 2, 4, 2, 3
    rng = np.random.default_rng(5)
    W = (rng.standard_normal((n_stages, d, d)) / 4.0).astype(np.float32)
    items = n_micro * mb * d
    data = rng.standard_normal(items + 10).astype(np.float32)
    mesh = make_mesh(("pp",), shape=(n_stages,), device="cpu")
    snk = VectorSink(np.float32)
    _run_fg(VectorSource(data), PpKernel(lambda w, a: torch.tanh(a @ w), W, mesh,
                                         np.float32, np.float32, micro_shape=(mb, d),
                                         n_micro=n_micro), snk)
    got = np.asarray(snk.items())
    assert got.shape == (items + 10,)
    padded = np.zeros(2 * items, np.float32)
    padded[:len(data)] = data
    ref = padded.reshape(-1, mb, d)
    for s in range(n_stages):
        ref = np.tanh(ref @ W[s])
    np.testing.assert_allclose(got, ref.reshape(-1)[:len(data)], rtol=2e-5, atol=2e-5)


def test_composed_pp_sp_mesh_with_midstream_checkpoint(tmp_path):
    """A (pp, sp) mesh: SpKernel along sp and PpKernel along pp in one
    flowgraph, interrupted halfway, its carry checkpointed through
    ``utils/checkpoint``, restored into fresh blocks and finished: the resumed
    run equals the whole one, and both equal the JAX package's single-device
    reference chain (``tests/test_parallel.py``'s composed case)."""
    from futuresdr_tpu_torch.utils.checkpoint import (load_flowgraph_state,
                                                      save_flowgraph_state)
    pp_n, sp_n, d, mb = 2, 2, 8, 2
    mesh = make_mesh(("pp", "sp"), shape=(pp_n, sp_n), device="cpu")
    F = 128 * sp_n
    n_micro = F // (mb * d)
    taps = np.hanning(32).astype(np.float32)
    rng = np.random.default_rng(17)
    W = rng.standard_normal((pp_n, d, d)).astype(np.float32) / 4.0
    data = rng.standard_normal(4 * F).astype(np.float32)

    def build(n_frames, offset=0):
        fn, initc = sp_fir_stream(taps, mesh)
        fg = Flowgraph()
        snk = VectorSink(np.float32)
        spk = SpKernel(fn, mesh, np.float32, np.float32, F, init_carry=initc)
        ppk = PpKernel(lambda w, a: torch.tanh(a @ w), W, mesh, np.float32, np.float32,
                       micro_shape=(mb, d), n_micro=n_micro, frames_in_flight=1)
        fg.connect(VectorSource(data[offset:offset + n_frames * F]), spk, ppk, snk)
        return fg, snk

    fg_a, snk_a = build(4)
    Runtime().run(fg_a)
    full = np.asarray(snk_a.items())
    fg_b, snk_b = build(2)
    Runtime().run(fg_b)
    path = str(tmp_path / "state")
    save_flowgraph_state(fg_b, path)
    fg_c, snk_c = build(2, offset=2 * F)
    assert load_flowgraph_state(fg_c, path) >= 1
    Runtime().run(fg_c)
    resumed = np.concatenate([np.asarray(snk_b.items()), np.asarray(snk_c.items())])
    np.testing.assert_array_equal(resumed, full)
    jm1 = _jmesh(1)
    ref = _jax_stream(*jpar.sp_fir_stream(taps, jm1),
                      [data[k * F:(k + 1) * F] for k in range(4)], jm1, np.float32)
    ref = ref.reshape(-1, mb, d)
    for s in range(pp_n):
        ref = np.tanh(ref @ W[s])
    np.testing.assert_allclose(full, ref.reshape(-1), rtol=TOL, atol=TOL)


def test_place_refuses_a_frame_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        place(np.zeros(D * 4 + 1, np.float32), _mesh())


def test_sharded_spectrum_app_runs_on_logical_cpu_devices(capsys):
    """The app's ``main()`` with ``--cpu``: its ``--devices`` logical CPU
    devices, the spectra's shape, and config ``virtual_devices`` restored
    after it (the app asks for them, nothing else keeps them)."""
    from futuresdr_tpu_torch.apps.sharded_spectrum import main
    config().virtual_devices = 0
    assert main(["--cpu", "--devices", "4", "--frames", "2", "--fft", "256",
                 "--frame-size", "16384"]) == 0
    out = capsys.readouterr().out
    assert "mesh: 4 logical shards on the CPU" in out and "64 x 256 bins" in out
    assert config().virtual_devices == 0


# ---- the sharded train step and the 3D composed mesh ----

STEP_TOL = 2e-6        # tests/test_torch_train.py: parameters after one Adam step
TINY_G = 1e-6          # entries whose |g| is below it step by rounding noise's sign


N_CLASSES, N_WIN = 11, 64     # the dryrun's MCLDNN: 11 classes, windows of 64


@pytest.fixture(scope="module")
def flax_mcldnn():
    """One flax MCLDNN init (``init_params``' seed 0, jitted: the same
    values, one compile) and its weights as the port's state dict, shared by
    the train cases."""
    from futuresdr_tpu.models.mcldnn import MCLDNN as FlaxMCLDNN
    from futuresdr_tpu_torch.convert import mcldnn_from_flax
    fm = FlaxMCLDNN(n_classes=N_CLASSES, conv_features=8, lstm_features=16)
    params = jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, N_WIN), jnp.float32))
    return fm, params, mcldnn_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _port_model(sd):
    from futuresdr_tpu_torch.models.mcldnn import MCLDNN, freeze_input_biases
    m = MCLDNN(n_classes=N_CLASSES, conv_features=8, lstm_features=16)
    m.load_state_dict(sd, strict=True)
    return freeze_input_biases(m)


def _jax_sharded_step(fm, params, mesh, axis, iq, labels, dp_axis="dp"):
    import optax
    from futuresdr_tpu.models.mcldnn import make_train_step as flax_step
    sharded, _ = jpar.shard_params(params, mesh, axis=axis)
    opt = optax.adam(1e-3)
    step = jax.jit(flax_step(fm, opt))
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(dp_axis)))  # noqa: E731
    stepped, _, loss, acc = step(sharded, opt.init(sharded), put(iq), put(labels))
    return stepped, float(loss), float(acc)


def _hold_step(st, sd0, jax_stepped, iq, labels):
    """The port's stepped weights against the JAX step's, where the one-device
    gradient's magnitude is above ``TINY_G``."""
    from futuresdr_tpu_torch.convert import mcldnn_from_flax
    from futuresdr_tpu_torch.models.mcldnn import loss_fn
    m = _port_model(sd0)
    loss, _ = loss_fn(m, torch.from_numpy(iq), torch.from_numpy(labels).long())
    loss.backward()
    grads = {k: p.grad for k, p in m.named_parameters()}
    want = mcldnn_from_flax(jax.tree_util.tree_map(np.asarray, jax_stepped))
    got = st.state_dict()
    for name, w in want.items():
        g = grads[name]
        if g is None:                           # a frozen input bias: never stepped
            assert float(got[name].abs().max()) == 0.0, name
            continue
        keep = g.abs().numpy() > TINY_G
        np.testing.assert_allclose(got[name].numpy()[keep], w.numpy()[keep], atol=STEP_TOL,
                                   err_msg=name)


def test_sharded_train_step_keeps_mp_shards_and_matches_jax(flax_mcldnn):
    """``tests/test_parallel.py``'s ``test_sharded_train_step_spmd`` on the
    port (at the dryrun's 11 classes): a (dp, mp) = (4, 2) mesh, the batch
    split over dp, the leaves that ``shard_params`` marks mp stored split
    over mp before and after the step; its loss, accuracy and stepped
    weights those of the JAX package's jitted step over the same shardings,
    from the same flax init."""
    from futuresdr_tpu_torch.models.mcldnn import loss_fn
    from futuresdr_tpu_torch.parallel.sharded_train import ShardedTrainStep
    fm, params, sd = flax_mcldnn
    iq = np.random.default_rng(0).standard_normal((8, 2, N_WIN)).astype(np.float32)
    labels = np.zeros(8, np.int32)
    jm = jpar.make_mesh(("dp", "mp"))
    stepped, jloss, jacc = _jax_sharded_step(fm, params, jm, "mp", iq, labels)
    mesh = make_mesh(("dp", "mp"), device="cpu")
    assert mesh.shape == {"dp": 4, "mp": 2}
    st = ShardedTrainStep(_port_model(sd), mesh, loss_fn)
    mp = st.mp_leaves()
    assert "fc1.weight" in mp and "head.weight" in mp
    loss, acc = st(torch.from_numpy(iq), torch.from_numpy(labels).long())
    assert abs(float(loss) - jloss) <= 1e-5 and float(acc) == jacc
    for d in range(4):                                 # every dp row, after the step
        for name in mp:
            leaf = st.params[d][name]
            assert len(leaf.shards) == 2 and leaf.axis == "mp"
            assert leaf.shards[0].shape[leaf.dim] * 2 == sd[name].shape[leaf.dim]
    _hold_step(st, sd, stepped, iq, labels)
    # the forward's gathers, the dp sum and its return, the gradient slices
    assert {"all_gather", "psum", "reduce_scatter"} <= set(mesh.transfers)


def test_composed_3d_mesh_stream_feeds_training_like_jax(flax_mcldnn):
    """``tests/test_parallel.py``'s 3D case on the port: SpKernel along sp and
    PpKernel along pp of a (dp, pp, sp) = (2, 2, 2) mesh in one flowgraph,
    its output the JAX package's same flowgraph's (rtol/atol 1e-4); that
    output trains MCLDNN on the same mesh, the batch over dp and the weights
    sharded along pp, with the JAX step's loss and weights."""
    from futuresdr_tpu import Flowgraph as JFlowgraph, Runtime as JRuntime
    from futuresdr_tpu.blocks import VectorSink as JSink, VectorSource as JSource
    from futuresdr_tpu.tpu import PpKernel as JPpKernel, SpKernel as JSpKernel
    from futuresdr_tpu_torch.models.mcldnn import loss_fn
    from futuresdr_tpu_torch.parallel.sharded_train import ShardedTrainStep
    d, mb, F = 16, 2, 256
    taps = np.hanning(32).astype(np.float32)
    W = np.random.default_rng(10).standard_normal((2, d, d)).astype(np.float32) / 4.0
    data = np.random.default_rng(11).standard_normal(2 * F).astype(np.float32)
    mesh3 = make_mesh(("dp", "pp", "sp"), shape=(2, 2, 2), device="cpu")
    fn, initc = sp_fir_stream(taps, mesh3)
    snk = VectorSink(np.float32)
    _run_fg(VectorSource(data), SpKernel(fn, mesh3, np.float32, np.float32, F,
                                         init_carry=initc),
            PpKernel(lambda w, a: torch.tanh(a @ w), W, mesh3, np.float32, np.float32,
                     micro_shape=(mb, d), n_micro=F // (mb * d), axis="pp",
                     frames_in_flight=1, wire="f32"), snk)
    got = np.asarray(snk.items())
    jm3 = jpar.make_mesh(("dp", "pp", "sp"), shape=(2, 2, 2), devices=jax.devices()[:8])
    jfn, jinit = jpar.sp_fir_stream(taps, jm3)
    jfg, jsnk = JFlowgraph(), JSink(np.float32)
    jfg.connect(JSource(data), JSpKernel(jfn, jm3, np.float32, np.float32, F,
                                         init_carry=jinit),
                JPpKernel(lambda w, a: jnp.tanh(a @ w), W, jm3, np.float32, np.float32,
                          micro_shape=(mb, d), n_micro=F // (mb * d), axis="pp",
                          frames_in_flight=1), jsnk)
    JRuntime().run(jfg)
    want = np.asarray(jsnk.items())
    assert got.shape == want.shape == (2 * F,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the stream's output trains on the same mesh
    b = 4
    L = got.size // (b * 2)
    assert L == N_WIN
    fm, params, sd = flax_mcldnn
    iq = got[:b * 2 * L].reshape(b, 2, L).astype(np.float32)
    labels = np.zeros(b, np.int32)
    stepped, jloss, _ = _jax_sharded_step(fm, params, jm3, "pp", iq, labels)
    st = ShardedTrainStep(_port_model(sd), mesh3, loss_fn, "dp", "pp")
    loss, _ = st(torch.from_numpy(iq), torch.from_numpy(labels).long())
    assert np.isfinite(float(loss)) and abs(float(loss) - jloss) <= 1e-5
    assert all(len(st.params[dd][k].shards) == 2 for dd in (0, 1) for k in st.mp_leaves())
    _hold_step(st, sd, stepped, iq, labels)
