"""The port's probe kernels' plain versions (probes/cf_act.py,
probes/sublane_ops.py) against the JAX probes' Pallas kernels in interpret
mode on the CPU, and the port's three standing rules over every module: no
import of jax or of the JAX package, entry points default to the GPU, and
no kernel wrapper gives way to its plain version for a tensor that is not on
the CPU. The JAX kernels' bodies are imported from `scripts/` here only.
"""

from __future__ import annotations

import ast
import importlib.util
import inspect
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dmel_codec_tpu_torch.cli import common, convert, evaluate, infer_lm, stream_codec, train_codec, train_lm
from dmel_codec_tpu_torch.eval import codecs
from dmel_codec_tpu_torch.eval.evaluation import Evaluation
from dmel_codec_tpu_torch.eval.external import WhisperASR, speaker_similarity
from dmel_codec_tpu_torch.ops import flash_attention as fa_ops
from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.anti_alias import anti_alias_activation, anti_alias_activation_reference
from dmel_codec_tpu_torch.ops.stage_fused import StageSpec, act_conv, amp_stage, amp_stage_v1
from dmel_codec_tpu_torch.probes import act_variants, cf_act, sublane_ops
from dmel_codec_tpu_torch.train.codec_trainer import CodecTrainer
from dmel_codec_tpu_torch.train.lm_loop import LMFitLoop
from dmel_codec_tpu_torch.train.lm_trainer import LMTrainer
from tests.test_torch_support import strict_f32  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("strict_f32")

ROOT = Path(__file__).resolve().parents[1]


def _script(name: str):
    """A module of `scripts/` (not a package), loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_cf():
    return _script("exp_cf_act")


@pytest.fixture(scope="module")
def jax_sublane():
    return _script("exp_sublane_ops")


def _cf_inputs(shape, seed: int):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = rng.standard_normal(shape).astype(np.float32)
    alpha = np.exp(rng.standard_normal(c).astype(np.float32) * 0.1)
    beta = np.exp(rng.standard_normal(c).astype(np.float32) * 0.1)
    return x, alpha, beta


# ---- P1 ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,w,halo", [((2, 24, 4096), 1024, 128), ((1, 5, 700), 256, 128),
                                         ((1, 3, 4099), 256, 128), ((2, 5, 257), 256, 128)])
def test_cf_act_plain_matches_jax_kernel(jax_cf, shape, w, halo):
    """P1's plain version against `cf_act_kernel` in interpret mode, beyond
    16 samples from either end: the JAX kernel uses a fitted sine
    (`_fast_sin`, ~1e-6) where the port uses the accurate one: 2e-5, the JAX
    probe's own gate. At the ends the TPU wrapper's edge padding is the
    port's replicate clamp, so they agree there too, to the same tolerance;
    T = 700 is no multiple of the window, T = 4099 and 257 leave one sample
    past a whole number of the kernel's 256-output units (and of the
    JAX window), where the card's kernel takes its element-by-element
    tail."""
    x, alpha, beta = _cf_inputs(shape, 0)
    ib = 1.0 / (beta + 1e-9)
    want = np.asarray(jax_cf.cf_act_windowed(
        jnp.asarray(x), jnp.asarray(alpha)[None, :, None], jnp.asarray(ib)[None, :, None],
        w=w, halo=halo, interpret=True))
    got = cf_act.cf_act_windowed(torch.from_numpy(x), torch.from_numpy(alpha)[None, :, None],
                                 torch.from_numpy(ib)[None, :, None], w).numpy()
    assert got.shape == want.shape == shape
    assert np.abs(got - want)[:, :, 16:-16].max() <= 2e-5
    assert np.abs(got - want).max() <= 2e-5


@pytest.mark.parametrize("shape", [(2, 24, 4096), (3, 7, 37)])
def test_cf_act_plain_is_k1_in_the_interior(shape):
    """P1 against the port's K1 plain version: the same function beyond 16
    samples from the ends (float32 sums in another order: 2e-5), and a
    different one at the ends, where K1 replicates the post-snake signal."""
    x, alpha, beta = _cf_inputs(shape, 1)
    xt, a, b = map(torch.from_numpy, (x, alpha, beta))
    got = cf_act.cf_act_reference(xt, a, 1.0 / (b + 1e-9))
    want = anti_alias_activation_reference(xt, a, b, logscale=False)
    diff = (got - want).abs()
    if shape[2] > 32:
        assert diff[:, :, 16:-16].max() <= 2e-5
    assert diff[:, :, :6].max() > 1e-4  # interior semantics only


def test_cf_act_plain_in_bfloat16_rounds_once():
    x, alpha, beta = _cf_inputs((2, 6, 300), 2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    a, ib = torch.from_numpy(alpha), 1.0 / (torch.from_numpy(beta) + 1e-9)
    got = cf_act.cf_act_windowed(xb, a, ib, 64)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, cf_act.cf_act_reference(xb.float(), a, ib).to(torch.bfloat16))


@pytest.mark.parametrize("shape,w", [((2, 24, 4096), 1024), ((1, 5, 700), 256)])
def test_cf_act_plain_bf16_matches_jax_kernel(jax_cf, shape, w):
    """On bf16 input P1's JAX kernel keeps float32 taps and a float32 snake
    output (`cf_act_kernel` works on `x.astype(float32)` with float32 taps
    and rounds once at the end), unlike K1's and K2's banded bf16 matmuls:
    P1's plain version, which does the same, gives at least 99 % of its
    bits, within half a bf16 ulp of max |y| (measured 0.9999 / 0.9997 and
    1.8e-3 / 2.9e-7; with bf16 taps and v it would be 0.573 / 0.558)."""
    x, alpha, beta = _cf_inputs(shape, 0)
    ib = 1.0 / (beta + 1e-9)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_cf.cf_act_windowed(xb, jnp.asarray(alpha)[None, :, None], jnp.asarray(ib)[None, :, None],
                                  w=w, halo=128, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = cf_act.cf_act_windowed(torch.from_numpy(x).bfloat16(), torch.from_numpy(alpha)[None, :, None],
                                 torch.from_numpy(ib)[None, :, None], w).float().numpy()
    assert (got == want).mean() >= 0.99
    assert np.abs(got - want).max() <= 2.0**-8 * np.abs(want).max()


@pytest.mark.parametrize("shape", cf_act.SHAPES)
def test_cf_act_operation_bound_at_the_probe_shapes(shape):
    """P1's bound by operations at each of the probe's shapes (36.96 M
    output samples each): 24 FIR FMAs less the three chains' first, which
    are multiplies (45; the up FIRs' gain of 2 lies in their taps), two
    snakes (4 each) and two sines at sinf's fast path (18 each) per sample,
    89 flops at the float32 rate; above the byte bound in bfloat16."""
    b, c, t = shape
    assert b * c * t == 36_962_304
    assert cf_act.FLOPS_PER_SAMPLE == 89
    assert cf_act.ops_bound_ms(shape) == pytest.approx(89 * 36_962_304 / 67e12 * 1e3)  # 0.0491 ms
    assert cf_act.ops_bound_ms(shape) > cf_act.bound_ms(shape)


def test_cf_act_window_sets_the_task_span():
    """The kernel's warp task spans ceil(w / 256) units of 256 outputs: w
    up to 256 one unit, the probe's 2048 eight, MAX_WINDOW 64."""
    assert [cf_act.units_per_task(w) for w in (1, 255, 256, 257, 2048, cf_act.MAX_WINDOW)] == [1, 1, 1, 2, 8, 64]


@pytest.mark.parametrize("w", [0, cf_act.MAX_WINDOW + 1])
def test_cf_act_refuses_a_window_it_cannot_stage(w):
    with pytest.raises(ValueError, match="window"):
        cf_act.cf_act_windowed(torch.zeros(1, 2, 8), torch.ones(2), torch.ones(2), w)


# ---- P2, P3 -----------------------------------------------------------------------


def _plane(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((sublane_ops.ROWS, sublane_ops.LANES)).astype(np.float32)


@pytest.mark.parametrize("name", ["slice", "roll"])
def test_rows_plain_equals_jax_kernel(jax_sublane, name):
    """P2 / P3 against `k_slice` / `k_roll` in interpret mode: the same
    additions in the same order, so the same bits."""
    x = _plane()
    kern = {"slice": jax_sublane.k_slice, "roll": jax_sublane.k_roll}[name]
    want = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((sublane_ops.OUT_ROWS, sublane_ops.LANES), jnp.float32),
        interpret=True)(jnp.asarray(x)))
    fn = {"slice": sublane_ops.slice_rows, "roll": sublane_ops.roll_rows}[name]
    got = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # and the definitions in numpy
    ref = {"slice": lambda: sum(x[off : off + 112] for off in sublane_ops.OFFSETS),
           "roll": lambda: sum(np.roll(x, off, 0)[:112] for off in sublane_ops.OFFSETS)}[name]()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lanes", [1, 33, 100])
@pytest.mark.parametrize("name", ["slice", "roll"])
def test_rows_plain_equals_jax_kernel_on_the_fewest_rows(jax_sublane, name, lanes):
    """P2 / P3 against `k_slice` / `k_roll` in interpret mode on planes of
    121 rows, the fewest the JAX kernels read (k_slice reads rows 0..120;
    k_roll rotates the whole plane, so here its wrap reaches rows 112..120),
    with column counts the card's kernel takes one float a thread (1, 33)
    and as float4s (100): the same bits."""
    x = np.random.default_rng(lanes).standard_normal((sublane_ops.OUT_ROWS + 9, lanes)).astype(np.float32)
    kern = {"slice": jax_sublane.k_slice, "roll": jax_sublane.k_roll}[name]
    want = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((sublane_ops.OUT_ROWS, lanes), jnp.float32), interpret=True)(jnp.asarray(x)))
    fn = {"slice": sublane_ops.slice_rows, "roll": sublane_ops.roll_rows}[name]
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("planes", [1, 3])
def test_slice_library_call_is_p2(planes):
    """P2's yardstick, one depthwise `F.conv1d` with 0/1 taps on the rows
    P2 reads, within `LIBRARY_TOL` of the plain P2."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((planes, sublane_ops.ROWS, sublane_ops.LANES))
                         .astype(np.float32))
    span = sublane_ops.OUT_ROWS + sublane_ops.OFFSETS[-1]
    got = sublane_ops.slice_library("cpu")(x[:, :span].transpose(1, 2).contiguous())
    want = sublane_ops.slice_reference(x)
    torch.testing.assert_close(got.transpose(1, 2), want, rtol=0,
                               atol=sublane_ops.LIBRARY_TOL * max(1.0, float(want.abs().max())))


def test_roll_is_not_the_slice_sum():
    """The JAX script prints `k_roll`'s result against the slice sum; they
    are two functions: rows i < 9 of the roll wrap to the plane's end."""
    x = torch.from_numpy(_plane(3))
    rolled, sliced = sublane_ops.roll_rows(x), sublane_ops.slice_rows(x)
    assert (rolled - sliced).abs().max() > 1.0
    assert torch.equal(rolled[0], x[0] + x[-1] + x[-3] + x[-5] + x[-7] + x[-9])
    assert torch.equal(sliced[0], x[0] + x[1] + x[3] + x[5] + x[7] + x[9])


@pytest.mark.parametrize("planes", [1, 3])
def test_roll_library_call_is_p3(planes):
    """P3's yardstick, one depthwise circular `nn.Conv1d` with 0/1 taps and
    P3's rows a view of its output, within `LIBRARY_TOL` of the plain P3."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((planes, sublane_ops.ROWS, sublane_ops.LANES))
                         .astype(np.float32))
    with torch.no_grad():
        got = sublane_ops.roll_library("cpu")(x.transpose(1, 2).contiguous())[..., : sublane_ops.OUT_ROWS]
    want = sublane_ops.roll_reference(x)
    torch.testing.assert_close(got.transpose(1, 2), want, rtol=0,
                               atol=sublane_ops.LIBRARY_TOL * max(1.0, float(want.abs().max())))


def test_rows_take_a_planes_axis_and_other_sizes():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 50, 7)).astype(np.float32))
    for fn in (sublane_ops.slice_rows, sublane_ops.roll_rows):
        got = fn(x, 17)
        assert got.shape == (3, 17, 7)
        assert torch.equal(got[1], fn(x[1], 17))


# ---- P4 ---------------------------------------------------------------------------


def _tap_matmul_against_k_matmul(jax_sublane, c: int, rows: int, seed: int):
    """P4's plain version against `k_matmul` in interpret mode on x [rows, C]
    @ w [C, C] (the JAX kernel's 11 taps of step 8 -> 1024 rows)."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((rows, c)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((c, c)), jnp.bfloat16)
    want = np.asarray(pl.pallas_call(
        partial(jax_sublane.k_matmul, taps=sublane_ops.TAPS),
        out_shape=jax.ShapeDtypeStruct((sublane_ops.MM_OUT, c), jnp.float32), interpret=True)(x, w))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    wt = torch.from_numpy(np.array(w.astype(jnp.float32))).to(torch.bfloat16)
    got = sublane_ops.tap_matmul(xt, wt)
    assert got.dtype == torch.float32 and got.shape == (sublane_ops.MM_OUT, c)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-2 * scale
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale  # what the CPU run shows


def test_tap_matmul_plain_matches_jax_kernel(jax_sublane):
    """P4 against `k_matmul` in interpret mode at the probe's shape: bf16
    operands and float32 sums on both sides, 11 x 96 products per output in
    another order (~1e-6 of max|y|); 1e-2 of max|y| is the gate the card's
    run uses too, where the tensor cores add in their own order."""
    _tap_matmul_against_k_matmul(jax_sublane, 96, sublane_ops.MM_ROWS, 5)


def test_tap_matmul_plain_matches_jax_kernel_at_k2_width(jax_sublane):
    """The same at K = N = 192 (K2's widest fused stage, which the wgmma
    kernel takes), on the fewest rows the JAX kernel reads (1024 + 80)."""
    _tap_matmul_against_k_matmul(jax_sublane, 192, sublane_ops.MM_OUT + 80, 7)


# (K, N, taps, step): what P4 takes and by which kernel; None = refused
TAP_SHAPES = [((96, 96, 11, 8), "wgmma"), ((192, 192, 11, 8), "wgmma"), ((256, 256, 11, 8), "wgmma"),
              ((128, 128, 7, 8), "wgmma"), ((32, 64, 17, 8), "wgmma"), ((96, 96, 18, 8), "mma"),
              ((192, 192, 11, 4), "mma"), ((32, 24, 5, 3), "mma"), ((16, 8, 1, 8), "mma"), ((48, 256, 3, 8), "mma"),
              ((264, 96, 11, 8), None), ((96, 264, 11, 8), None), ((200, 96, 11, 8), None), ((96, 100, 11, 8), None),
              ((8, 8, 1, 8), None)]


@pytest.mark.parametrize("shape,path", TAP_SHAPES, ids=lambda v: str(v))
def test_tap_matmul_widths_and_paths(monkeypatch, shape, path):
    """The wrapper on a tensor that is not on the CPU (`meta`, with the
    library and the device check stood in for): K and N multiples of 16 and
    8 up to 256 launch, by the kernel that `tap_matmul_path` names and with
    that path's count; wider or ragged widths raise before any launch."""
    k, n, taps, step = shape
    calls = []

    class Lib:
        def dmel_tap_matmul(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(library, "load", lambda: Lib())
    monkeypatch.setattr(sublane_ops, "_planes", lambda x, dtype, name: x if x.dim() == 3 else x[None])
    monkeypatch.setattr(library, "stream", lambda x: 0)
    x = torch.empty((2, 130 + step * (taps - 1), k), device="meta", dtype=torch.bfloat16)
    w = torch.empty((k, n), device="meta", dtype=torch.bfloat16)
    before = (sublane_ops.tap_matmul.launches, dict(sublane_ops.tap_matmul.launches_by_path))
    if path is None:
        with pytest.raises(ValueError, match="multiple of 16 and N of 8"):
            sublane_ops.tap_matmul(x, w, 130, taps, step)
        assert not calls and sublane_ops.tap_matmul.launches == before[0]
        return
    assert sublane_ops.tap_matmul_path(k, n, taps, step) == path
    y = sublane_ops.tap_matmul(x, w, 130, taps, step)
    assert y.shape == (2, 130, n) and y.dtype == torch.float32
    (args,) = calls
    assert args[3:11] == (2, 130 + step * (taps - 1), 130, k, n, taps, step, int(path == "wgmma"))
    assert sublane_ops.tap_matmul.launches == before[0] + 1
    assert sublane_ops.tap_matmul.launches_by_path[path] == before[1][path] + 1


def test_tap_matmul_is_a_dilated_conv():
    """The tap-matmul form equals an 11-tap conv whose taps all hold w."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 140, 32)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32)).to(torch.bfloat16)
    got = sublane_ops.tap_matmul(x, w, out_rows=100, taps=5, step=8)
    kernel = w.float().T[:, :, None].expand(16, 32, 5)
    want = torch.nn.functional.conv1d(x[:, :132].float().transpose(1, 2), kernel, dilation=8).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_tap_matmul_bound_at_k2_width():
    """P4's bound at 264 planes of x [2176, 192] @ w [192, 192]: 219 GFLOP
    at the bf16 rate, and the 1104 rows read, y and w in bytes."""
    b = sublane_ops.tap_matmul_bound_ms(264, 192, 192)
    flops = 264 * 11 * 2 * 1024 * 192 * 192
    assert flops == 219_244_658_688
    assert b["operations"] == pytest.approx(flops / 989e12 * 1e3)  # 0.2217 ms
    assert b["bytes"] == pytest.approx((264 * (1104 * 192 * 2 + 1024 * 192 * 4) + 192 * 192 * 2) / 3.35e12 * 1e3)
    assert b["operations"] > b["bytes"]


def test_bounds_count_this_shape():
    assert sublane_ops.TAPS * 2 * sublane_ops.MM_OUT * 96 * 96 == 207_618_048  # the probe's 207.6 MFLOP
    b = sublane_ops.tap_matmul_bound_ms(1)
    assert b["operations"] == pytest.approx(207_618_048 / 989e12 * 1e3)
    assert b["bytes"] == pytest.approx(((1024 + 80) * 96 * 2 + 1024 * 96 * 4 + 96 * 96 * 2) / 3.35e12 * 1e3)
    assert sublane_ops.rows_bound_ms(2) == pytest.approx(2 * (112 + 121) * 96 * 4 / 3.35e12 * 1e3)
    assert cf_act.bound_ms((16, 96, 24064)) == pytest.approx(2 * 16 * 96 * 24064 * 2 / 3.35e12 * 1e3)


# ---- the port's standing rules ----------------------------------------------------

PORT_FILES = (sorted((ROOT / "dmel_codec_tpu_torch").rglob("*.py")) + [ROOT / "tests" / "card.py"]
              + sorted((ROOT / "tests").glob("test_torch_card_*.py"))
              + sorted((ROOT / "tests").glob("torch_*_worker.py")))
FORBIDDEN = ("jax", "flax", "optax", "dmel_codec_tpu", "scripts")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    """No module of the port, no file of the card suite (`tests/card.py`,
    `tests/test_torch_card_*.py`, which run on a card without JAX) and no
    test worker (`tests/torch_*_worker.py`) imports jax, flax, optax, the
    JAX package or `scripts/` (anywhere: function bodies too)."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"


@pytest.mark.parametrize("module", [convert, evaluate, infer_lm, stream_codec, train_lm, train_codec],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_entry_point_defaults_to_the_gpu(module, monkeypatch):
    """Each CLI parses `--device` with the default "cuda"."""
    seen = {}
    real = module.argparse.ArgumentParser.parse_args

    def parse(self, argv=None):
        ns = real(self, argv)
        seen["device"] = ns.device
        raise SystemExit(0)

    monkeypatch.setattr(module.argparse.ArgumentParser, "parse_args", parse)
    required = {"convert": ["vqgan", "--ckpt", "c", "--out", "o"], "evaluate": ["--config", "c"], "infer_lm": ["--config", "c"], "stream_codec": ["--in", "x.wav"],
                "train_lm": ["--config", "c"], "train_codec": ["--config", "c"]}[module.__name__.split(".")[-1]]
    with pytest.raises(SystemExit):
        module.main(required)
    assert seen["device"] == "cuda"


@pytest.mark.parametrize("fn", [CodecTrainer.__init__, LMTrainer.__init__, LMFitLoop.__init__, common.load_codec_adapter,
                                Evaluation.__init__, codecs.FishSpeechAdapter.__init__,
                                codecs.SpeechTokenizerAdapter.__init__, codecs.EncodecAdapter.__init__,
                                codecs.DacCodecAdapter.__init__, codecs.MimiCodecAdapter.__init__,
                                WhisperASR.__init__, speaker_similarity],
                         ids=lambda f: f.__qualname__)
def test_library_entry_defaults_to_the_gpu(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _wrapper_calls():
    """(name, counted wrapper, call on a tensor of a given device)."""
    spec = StageSpec(channels=8)

    def on(device, *shape, dtype=torch.float32):
        return torch.zeros(shape, device=device, dtype=dtype)

    def packed(device):
        return {"w": [on(device, k, 8, 8) for k in spec.kernel_sizes for _ in range(6)], "b": on(device, 8, 18),
                "a": on(device, 8, 18), "ib": on(device, 8, 18)}

    return [
        ("K1", anti_alias_activation, lambda d: anti_alias_activation(on(d, 1, 8, 50), on(d, 8), on(d, 8), True)),
        ("K2", amp_stage, lambda d: amp_stage(on(d, 1, 8, 50), packed(d), spec)),
        ("K2 bf16", amp_stage, lambda d: amp_stage(on(d, 1, 8, 50, dtype=torch.bfloat16), packed(d), spec)),
        ("K2 launch", amp_stage,
         lambda d: act_conv(on(d, 1, 8, 50), packed(d), spec, 4, torch.bfloat16, res=on(d, 1, 8, 50))),
        ("K2-v1", amp_stage_v1, lambda d: amp_stage_v1(on(d, 1, 8, 50), packed(d), spec)),
        ("FA", fa_ops.flash_attention,
         lambda d: fa_ops.flash_attention(on(d, 1, 8, 4, 16), on(d, 1, 8, 2, 16), on(d, 1, 8, 2, 16))),
        ("FA-dKV", fa_ops.flash_attention_dkv,
         lambda d: fa_ops.flash_attention_dkv(on(d, 1, 8, 4, 16), on(d, 1, 8, 2, 16), on(d, 1, 8, 2, 16),
                                              on(d, 1, 8, 4, 16), on(d, 1, 4, 8), on(d, 1, 4, 8))),
        ("FA-dQ", fa_ops.flash_attention_dq,
         lambda d: fa_ops.flash_attention_dq(on(d, 1, 8, 4, 16), on(d, 1, 8, 2, 16), on(d, 1, 8, 2, 16),
                                             on(d, 1, 8, 4, 16), on(d, 1, 4, 8), on(d, 1, 4, 8))),
        ("probe", act_variants.run_variant, lambda d: act_variants.run_variant(on(d, 1, 8, 50), on(d, 8), on(d, 8), "copy")),
        ("P1", cf_act.cf_act_windowed, lambda d: cf_act.cf_act_windowed(on(d, 1, 8, 50), on(d, 8), on(d, 8), 16)),
        ("P2", sublane_ops.slice_rows, lambda d: sublane_ops.slice_rows(on(d, 30, 8), 4)),
        ("P3", sublane_ops.roll_rows, lambda d: sublane_ops.roll_rows(on(d, 30, 8), 4)),
        ("P4", sublane_ops.tap_matmul,
         lambda d: sublane_ops.tap_matmul(on(d, 40, 16, dtype=torch.bfloat16), on(d, 16, 8, dtype=torch.bfloat16), 8, 3, 8)),
    ]


@pytest.mark.parametrize("case", _wrapper_calls(), ids=lambda c: c[0])
def test_wrapper_never_falls_back(case, monkeypatch, tmp_path):
    """A tensor that is not on the CPU (here: on `meta`, which has no
    storage) goes to the kernel library; where that cannot be built (no
    nvcc), the wrapper raises the build's error, launches nothing and
    counts nothing. A CPU tensor never touches the library."""
    name, wrapper, call = case
    monkeypatch.setattr(library, "find_nvcc", lambda: None)
    monkeypatch.setattr(library, "BUILD_DIR", tmp_path)
    library.load.cache_clear()
    before = wrapper.launches
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call("meta")
        assert wrapper.launches == before
    finally:
        library.load.cache_clear()
    if name not in ("FA-dKV", "FA-dQ"):  # the backward kernels' plain versions take the forward's output too
        with monkeypatch.context() as m:
            m.setattr(library, "load", lambda: pytest.fail("a CPU tensor must not reach the kernel library"))
            call("cpu")
            assert wrapper.launches == before
