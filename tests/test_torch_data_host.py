"""The port's host data path against the JAX package's, on the same seeded
WAVs: the loader's sharding, fillers and decode backends (F3), the native
C++ decode kernels (`native/`, built with the host compiler into `build/`),
`data/preprocess.py` and `cli.preprocess`.

Tolerances as `tests/test_native_audio.py`: 1e-6 where only the decode
differs (float32 scaling of integer samples), 2e-5 where a resampling FIR
sums in another order; equal where both sides run the same code.
"""

from __future__ import annotations

import dataclasses
import json
import threading

import numpy as np
import pytest
from scipy.io import wavfile

from dmel_codec_tpu.cli import preprocess as jax_preprocess_cli
from dmel_codec_tpu.data import audio as jax_audio
from dmel_codec_tpu.data import loader as jax_loader
from dmel_codec_tpu.data import manifest as jax_manifest
from dmel_codec_tpu.data import preprocess as jax_preprocess
from dmel_codec_tpu_torch.cli import preprocess as port_preprocess_cli
from dmel_codec_tpu_torch.data import audio as port_audio
from dmel_codec_tpu_torch.data import loader as port_loader
from dmel_codec_tpu_torch.data import manifest as port_manifest
from dmel_codec_tpu_torch.data import preprocess as port_preprocess
from dmel_codec_tpu_torch.native import build as native_build

RATES = (16000, 24000, 44100)


def _pcm(rng, n: int, dtype, channels: int = 1) -> np.ndarray:
    x = rng.standard_normal((n, channels) if channels > 1 else n) * 0.3
    if dtype == np.int16:
        return np.clip(x * 32767, -32767, 32767).astype(np.int16)
    if dtype == np.int32:
        return np.clip(x * (2**31 - 1), -(2**31 - 1), 2**31 - 1).astype(np.int32)
    if dtype == np.uint8:
        return np.clip(x * 127 + 128, 0, 255).astype(np.uint8)
    return x.astype(dtype)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 WAVs, int16 at three rates and 0.2..0.75 s, each with a transcript;
    the manifest of both packages' `Cut` (the same fields)."""
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    cuts = []
    for i in range(12):
        sr = RATES[i % 3]
        dur = 0.2 + 0.05 * i
        path = root / f"utt{i:02d}.wav"
        wavfile.write(path, sr, _pcm(rng, int(sr * dur), np.int16, channels=1 + i % 2))
        cuts.append(port_manifest.Cut(id=f"utt{i:02d}", audio_path=str(path), start=0.0, duration=dur,
                                      sampling_rate=sr, text=f"text {i}"))
    return root, cuts


def _jax_cuts(cuts):
    return [jax_manifest.Cut(**dataclasses.asdict(c)) for c in cuts]


def _as_dicts(cuts):
    return [dataclasses.asdict(c) for c in cuts]


# ---- F3: the loader's sharding, fillers and backend ------------------------------------------

SHARDS = [(1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2)]


@pytest.mark.parametrize("batch_multiple", [1, 4])
@pytest.mark.parametrize("num_shards,shard_index", SHARDS)
def test_loader_batches_match_jax(corpus, num_shards, shard_index, batch_multiple):
    """The same cut ids per batch (the shard taken before the duration
    sort), the same audios and lengths (fillers: zero rows, length 0, text
    None) in the same shuffled order, epoch 1."""
    _, cuts = corpus
    kw = dict(max_duration=1.2, seed=3, num_shards=num_shards, shard_index=shard_index, num_workers=2)
    port = port_loader.DataLoader(cuts, batch_multiple=batch_multiple, audio_backend="python", **kw)
    jax_ = jax_loader.DataLoader(_jax_cuts(cuts), batch_multiple=batch_multiple, audio_backend="python", **kw)
    assert [[c.id for c in b] for b in port.batcher.batches(1)] == [[c.id for c in b] for b in jax_.batcher.batches(1)]
    got, want = list(port.epoch(1)), list(jax_.epoch(1))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["texts"] == w["texts"]
        np.testing.assert_array_equal(g["audio_lengths"], w["audio_lengths"])
        np.testing.assert_array_equal(g["audios"], w["audios"])
        assert len(g["texts"]) % batch_multiple == 0
        fillers = [i for i, t in enumerate(g["texts"]) if t is None]
        assert all(g["audio_lengths"][i] == 0 and not g["audios"][i].any() for i in fillers)
    ids = [c.id for b in port.batcher.batches(0) for c in b]
    assert sorted(ids) == sorted(c.id for c in cuts[shard_index::num_shards])


def test_loader_native_backend_matches_python(corpus):
    """`audio_backend="native"` gives the scipy backend's batches within
    2e-5 (resampled clips among them); an unknown backend is refused."""
    _, cuts = corpus
    kw = dict(max_duration=1.2, shuffle=False, num_workers=2)
    native = list(port_loader.DataLoader(cuts, audio_backend="native", **kw))
    python = list(port_loader.DataLoader(cuts, audio_backend="python", **kw))
    for a, b in zip(native, python):
        np.testing.assert_array_equal(a["audio_lengths"], b["audio_lengths"])
        np.testing.assert_allclose(a["audios"], b["audios"], atol=2e-5)
    with pytest.raises(ValueError, match="audio_backend"):
        port_loader.DataLoader(cuts, audio_backend="sox")


# ---- the native decode kernels ------------------------------------------------------------

FORMATS = [(np.int16, 1), (np.int32, 1), (np.float32, 1), (np.uint8, 1), (np.int16, 2), (np.float32, 2)]


@pytest.mark.parametrize("dtype,channels", FORMATS, ids=lambda v: getattr(v, "__name__", str(v)))
def test_native_decode_matches_jax_native_and_python(tmp_path, dtype, channels):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 24000, _pcm(rng, 5000, dtype, channels))
    got = port_audio.load_audio_native(path, target_sr=24000)
    np.testing.assert_array_equal(got, jax_audio.load_audio_native(path, target_sr=24000))
    np.testing.assert_allclose(got, port_audio.load_audio_python(path, target_sr=24000), atol=1e-6)


@pytest.mark.parametrize("src_sr", [8000, 16000, 22050, 44100, 48000])
def test_native_resample_matches_jax_native_and_python(tmp_path, src_sr):
    rng = np.random.default_rng(src_sr)
    path = str(tmp_path / f"r{src_sr}.wav")
    wavfile.write(path, src_sr, _pcm(rng, int(src_sr * 1.3), np.int16))
    got = port_audio.load_audio_native(path, target_sr=24000, normalize=False)
    np.testing.assert_array_equal(got, jax_audio.load_audio_native(path, target_sr=24000, normalize=False))
    want = port_audio.load_audio_python(path, target_sr=24000, normalize=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_native_slice_and_normalize_match(tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "s.wav")
    wavfile.write(path, 44100, _pcm(rng, 44100 * 2, np.int16))
    kw = dict(target_sr=24000, start=0.37, duration=0.81)
    got = port_audio.load_audio(path, backend="native", **kw)
    np.testing.assert_array_equal(got, jax_audio.load_audio(path, backend="native", **kw))
    want = port_audio.load_audio(path, backend="python", **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert abs(np.abs(got).max() - 0.95) < 1e-3
    np.testing.assert_array_equal(port_audio.load_audio(path, backend="auto", **kw), got)


def _broken_build(monkeypatch, tmp_path):
    """The kernels' source replaced by one that does not compile, a fresh
    build directory and no library loaded yet."""
    bad = tmp_path / "audio_kernels.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SRC", bad)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "_LIB", None)
    monkeypatch.setattr(native_build, "_ERROR", None)


def test_native_backend_raises_when_the_build_fails(tmp_path, monkeypatch):
    """'native' raises the compiler's failure (and again at once on the next
    call); 'auto' falls back to scipy; nothing is left in the build
    directory."""
    path = str(tmp_path / "p.wav")
    wavfile.write(path, 24000, _pcm(np.random.default_rng(3), 2400, np.int16))
    _broken_build(monkeypatch, tmp_path)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="could not build the native audio kernels"):
            port_audio.load_audio(path, backend="native")
    assert not native_build.native_available()
    np.testing.assert_array_equal(port_audio.load_audio(path, backend="auto"),
                                  port_audio.load_audio(path, backend="python"))
    assert list((tmp_path / "build").iterdir()) == []
    with pytest.raises(ValueError, match="audio backend"):
        port_audio.load_audio(path, backend="sox")


def test_native_backend_raises_on_a_file_it_cannot_read(tmp_path):
    path = tmp_path / "x.wav"
    path.write_bytes(b"RIFF....WAVEjunk")
    with pytest.raises(RuntimeError, match="could not read"):
        port_audio.load_audio(str(path), backend="native")


def test_concurrent_builds_leave_one_library(tmp_path, monkeypatch):
    """Three threads build into an empty directory at once (the six test
    workers, or the ranks of a run, do so in processes): each gets the same
    file, written by an atomic rename, and no temporary file is left."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native_build.build())
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    assert paths[0].name == f"audio_kernels_{native_build.library_path().name.split('_')[-1]}"


# ---- data/preprocess.py and cli.preprocess -------------------------------------------------


def _call(module, name, root, cuts, tmp_path):
    """`name` of `module` (the port's or the JAX package's preprocess) on the
    corpus; what it returns, as plain values."""
    fn = getattr(module, name)
    cut_type = port_manifest.Cut if module is port_preprocess else jax_manifest.Cut
    mine = [cut_type(**dataclasses.asdict(c)) for c in cuts]
    transcripts = {c.id: c.text for c in cuts[::2]}
    if name == "cuts_from_paths":
        return _as_dicts(fn([c.audio_path for c in cuts[:5]], transcripts))
    if name == "cuts_from_dir":
        return _as_dicts(fn(str(root), transcripts))
    if name == "cut_into_windows":
        return _as_dicts(fn(mine, 0.3))
    if name == "filter_by_duration":
        return _as_dicts(fn(mine, 0.3, 0.6)) + _as_dicts(fn(mine, min_duration=0.5))
    if name == "duration_stats":
        return [fn(mine), fn([])]
    out = tmp_path / f"{module.__name__.split('.')[0]}.jsonl.gz"
    if name == "prepare_manifests":
        stats = fn(mine, str(out), window_seconds=0.25, min_duration=0.1, shuffle_seed=4)
        return [stats, _as_dicts(port_manifest.load_manifest(str(out)))]
    assert name == "sort_cuts_by_duration"
    port_manifest.save_manifest(cuts[::-1], str(tmp_path / "in.jsonl"))
    n = fn(str(tmp_path / "in.jsonl"), str(out), descending=True)
    return [n, _as_dicts(port_manifest.load_manifest(str(out)))]


@pytest.mark.parametrize("name", ["cuts_from_paths", "cuts_from_dir", "cut_into_windows", "filter_by_duration",
                                  "duration_stats", "prepare_manifests", "sort_cuts_by_duration"])
def test_preprocess_matches_jax(corpus, tmp_path, name):
    root, cuts = corpus
    got = _call(port_preprocess, name, root, cuts, tmp_path)
    want = _call(jax_preprocess, name, root, cuts, tmp_path)
    assert got == want
    assert got and got != [[]]


def test_preprocess_cli_matches_jax(corpus, tmp_path, capsys):
    """`cli.preprocess.main` with transcripts, windows, both duration
    filters and a seed: the same manifest and the same printed stats."""
    root, cuts = corpus
    tsv = tmp_path / "t.tsv"
    tsv.write_text("".join(f"{c.id}\t{c.text}\n" for c in cuts[1::2]))
    args = ["--wav-dir", str(root), "--transcripts", str(tsv), "--window", "0.3", "--min-duration", "0.1",
            "--max-duration", "0.3", "--seed", "7"]
    port_preprocess_cli.main(args + ["--out", str(tmp_path / "port.jsonl.gz")])
    port_out = capsys.readouterr().out
    jax_preprocess_cli.main(args + ["--out", str(tmp_path / "jax.jsonl.gz")])
    assert json.loads(port_out) == json.loads(capsys.readouterr().out)
    got = _as_dicts(port_manifest.load_manifest(str(tmp_path / "port.jsonl.gz")))
    assert got == _as_dicts(port_manifest.load_manifest(str(tmp_path / "jax.jsonl.gz")))
    assert len(got) > len(cuts) and sum(c["text"] is not None for c in got) > 0


def test_preprocess_reads_float_wavs(tmp_path):
    """IEEE-float WAVs (which `wave` cannot open, so the JAX function raises)
    get their rate and length from the data chunk."""
    import wave

    wavfile.write(tmp_path / "f.wav", 16000, np.zeros(4000, np.float32))
    (cut,) = port_preprocess.cuts_from_paths([str(tmp_path / "f.wav")])
    assert (cut.sampling_rate, cut.duration) == (16000, 0.25)
    with pytest.raises(wave.Error):
        jax_preprocess.cuts_from_paths([str(tmp_path / "f.wav")])
