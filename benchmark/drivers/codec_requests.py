"""Closed-loop codec requests: each request is a batch of clips through
`DMelCodecAdapter.encode` -> `.decode` to waveforms on the host, as
evaluation, corpus tokenisation and an online codec service send them.

Traffic parameters (the workload file's "params"):
  batch           clips per request, padded to the longest
  seconds_min, seconds_max, seconds_step
                  clip lengths: the grid min, min + step, ..., max; the
                  clips' lengths run through shuffled blocks of the whole
                  grid, so every seed sends the same sizes in another order
  cycle           requests made in set-up and sent in turn
  check_requests  requests the reference recomputes after the window
                  (drawn from the seed, the longest among them)
  limits          each compared number's limit
Every padded length the cycle holds is warmed up in set-up.

Spans: "request", "codec.mel" (the log-mel front end), "codec.encode",
"codec.decode", "vocoder.pre", "vocoder.s<i>", "vocoder.post".
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness import weights
from benchmark.harness.trace import span
from benchmark.reference import bigvgan as ref_bigvgan
from benchmark.reference import codec as ref_codec
from benchmark.reference import precision

POOL_CLIPS = 32


def _tuples(d: dict) -> dict:
    return {k: tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list) else v
            for k, v in d.items()}


def make_params(cfg: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The codec's and the vocoder's parameters from one seeded draw:
    {"codec": {...}, "vocoder": {...}} under checkpoint names."""
    shapes = {f"codec.{k}": s for k, s in ref_codec.param_shapes(cfg["codec"]).items()}
    shapes.update({f"vocoder.{k}": s for k, s in ref_bigvgan.param_shapes(cfg["vocoder"]).items()})
    flat = weights.make(shapes, seed, dtype, device, gains=cfg.get("weight_gains"))
    return {part: {k[len(part) + 1:]: v for k, v in flat.items() if k.startswith(part + ".")}
            for part in ("codec", "vocoder")}


def valid_frames(samples: np.ndarray, cfg: dict) -> np.ndarray:
    """The mel frames the codec takes as audio: samples // hop, floored to
    the downsampling factor (DMelCodecAdapter's lengths)."""
    f = int(np.prod(cfg["downsample_factor"]))
    return (np.asarray(samples) // cfg["hop_length"] // f) * f


def mel_frames(padded: int, cfg: dict) -> int:
    """Frames of the front end on `padded` samples, floored to the
    downsampling factor."""
    frames = 1 + (padded + 2 * ((1024 - cfg["hop_length"]) // 2) - 1024) // cfg["hop_length"]
    f = int(np.prod(cfg["downsample_factor"]))
    return (frames // f) * f


def clip_lengths(params: dict, seed: int, count: int, sample_rate: int) -> np.ndarray:
    """`count` clip lengths in samples: shuffled blocks of the length grid."""
    lo, hi, step = params["seconds_min"], params["seconds_max"], params["seconds_step"]
    grid = np.round(np.arange(lo, hi + step / 2, step) * sample_rate).astype(np.int64)
    rng = np.random.default_rng(seed)
    blocks = -(-count // len(grid))
    return np.concatenate([rng.permutation(grid) for _ in range(blocks)])[:count]


def audio_pool(seed: int, clips: int, samples: int, sample_rate: int, device) -> np.ndarray:
    """Seeded clips [clips, samples], float32 on the host: three tones of
    log-uniform frequency (80 Hz - 4 kHz), random amplitude and phase, a
    slow envelope and a little noise; made on the device in a few calls."""
    g = torch.Generator(device=device).manual_seed((int(seed) + 7) % (2**63))
    t = torch.arange(samples, device=device, dtype=torch.float32)[None, None, :] / sample_rate
    r = torch.rand((clips, 3, 4), generator=g, device=device)
    freq = 80.0 * 50.0 ** r[..., 0:1]
    amp = 0.05 + 0.25 * r[..., 1:2]
    tones = (amp * torch.sin(2 * np.pi * freq * t + 2 * np.pi * r[..., 2:3])).sum(1)
    env = 0.6 + 0.4 * torch.sin(2 * np.pi * (0.5 + 2 * r[:, 0, 3:4]) * t[:, 0])
    noise = 0.01 * torch.randn((clips, samples), generator=g, device=device)
    return (tones * env + noise).cpu().numpy()


def _spanned(name, fn):
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return call


def build_adapter(cfg: dict, seed: int, dtype: torch.dtype, device, noise_seed: int):
    """DMelCodecAdapter over the configuration's codec and vocoder, built on
    the meta device and given the seed's parameters in `dtype` (a bf16
    codec computes in bf16, as `compute_dtype` says), with the spans
    codec.encode, codec.decode, vocoder.pre, vocoder.s<i>, vocoder.post
    around the program's own calls."""
    from dmel_codec_tpu_torch.eval.codecs import DMelCodecAdapter
    from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig

    if cfg["fuse_max_channels"] != 192:
        raise ValueError("DMelCodecAdapter serves FusedBigVGAN with fuse_max_channels=192")
    cc = dict(cfg["codec"], compute_dtype=None if dtype == torch.float32 else str(dtype).split(".")[-1])
    params = make_params(cfg, seed, dtype, device)
    with torch.device("meta"):
        codec = DMelCodec(DMelCodecConfig(**_tuples(cc))).to(dtype)
        vocoder = BigVGAN(BigVGANConfig(**_tuples(cfg["vocoder"]))).to(dtype)
    codec.load_state_dict(params["codec"], strict=True, assign=True)
    vocoder.load_state_dict(params["vocoder"], strict=True, assign=True)
    a = DMelCodecAdapter(codec, vocoder, seed=noise_seed)
    a.codec.encode = _spanned("codec.encode", a.codec.encode)
    a.codec.decode = _spanned("codec.decode", a.codec.decode)
    voc = a.vocoder
    voc.pre = _spanned("vocoder.pre", voc.pre)
    voc.post = _spanned("vocoder.post", voc.post)
    stage = voc.stage

    def stage_spanned(i, x):
        with span(f"vocoder.s{i}"):
            return stage(i, x)

    voc.stage = stage_spanned
    return a


class Driver:
    spans = ("request", "codec.", "vocoder.")

    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg = cell.config
        self.p = cell.workload["params"]
        self.seed = int(seed)
        self.noise_seed = (self.seed * 2654435761 + 1) % (2**63)
        self.device = device
        self.dtype = getattr(torch, self.cfg["dtype"])
        self.k = 0
        self.calls: List[Tuple[object, int, int]] = []  # (request or None, clips, padded samples) per decode
        self.outputs: Dict[int, dict] = {}
        self.requests: List[Tuple[np.ndarray, np.ndarray]] = []

    # ---- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from dmel_codec_tpu_torch.utils.precision import strict_float32

        strict_float32()  # as every entry point of the program does before it builds a model
        cc = self.cfg["codec"]
        self.adapter = build_adapter(self.cfg, self.seed, self.dtype, self.device, self.noise_seed)
        self._mel = None
        a = self.adapter

        def mel_forward(audio, _forward=a.mel_tf.forward):
            with span("codec.mel"):
                self._mel = _forward(audio)
            return self._mel

        a.mel_tf.forward = mel_forward

        sr, b = cc["sample_rate"], self.p["batch"]
        lengths = clip_lengths(self.p, self.seed, self.p["cycle"] * b, sr)
        pool = audio_pool(self.seed, POOL_CLIPS, int(lengths.max()), sr, self.device)
        for k in range(self.p["cycle"]):
            ls = lengths[k * b:(k + 1) * b]
            audio = np.zeros((b, int(ls.max())), np.float32)
            for i, n in enumerate(ls):
                audio[i, :n] = pool[(k * b + i) % POOL_CLIPS, :n]
            self.requests.append((audio, ls))
        warmed = set()
        for audio, ls in self.requests:  # every padded shape the cycle holds
            if audio.shape not in warmed:
                warmed.add(audio.shape)
                self._request(None, audio, ls)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the timed path -------------------------------------------------
    def _request(self, key, audio: np.ndarray, lengths: np.ndarray):
        a = self.adapter
        with span("request"):
            idx, idx_len = a.encode(audio, lengths)
            self.calls.append((key, audio.shape[0], audio.shape[1]))
            wav, mel_out = a.decode(idx, idx_len)
        return idx, idx_len, wav, mel_out

    def step(self) -> dict:
        k = self.k
        self.k += 1
        audio, lengths = self.requests[k % len(self.requests)]
        start = time.perf_counter()
        idx, idx_len, wav, mel_out = self._request(k, audio, lengths)
        end = time.perf_counter()
        self.outputs[k] = {"mel_in": self._mel, "indices": idx, "wav": wav, "mel_out": mel_out}
        return {"k": k, "start": start, "end": end, "latency_s": end - start,
                "audio_s": float(lengths.sum()) / self.cfg["codec"]["sample_rate"],
                "frames": [int(f) for f in valid_frames(lengths, self.cfg["codec"])],
                "padded": int(audio.shape[1])}

    def release(self) -> None:
        for out in self.outputs.values():
            out["mel_in"] = out["mel_in"].float().cpu().numpy()
        del self.adapter
        self._mel = None

    # ---- the check --------------------------------------------------------
    def sample(self, records: List[dict]) -> List[int]:
        """The requests the reference recomputes: drawn from the seed, with
        the longest of the window among them."""
        longest = max(records, key=lambda r: (r["padded"] * len(r["frames"]), -r["k"]))["k"]
        rest = [r["k"] for r in records if r["k"] != longest]
        rng = np.random.default_rng(self.seed + 1)
        n = min(len(rest), self.p["check_requests"] - 1)
        return [longest] + sorted(int(k) for k in rng.choice(rest, size=n, replace=False))

    def noises(self, keys) -> Dict[int, torch.Tensor]:
        """The decoder's noise of each of `keys`, drawn again as the adapter
        draws it: one seeded generator on the device, one draw of [clips,
        frames, concat] per decode call, in the order of the calls."""
        cc = self.cfg["codec"]
        concat = cc["dmel_groups"] * cc["encoder_residual_channels"]
        g = torch.Generator(device=self.device).manual_seed(self.noise_seed)
        out = {}
        for key, b, padded in self.calls:
            z = torch.randn((b, mel_frames(padded, cc), concat), generator=g, device=self.device, dtype=self.dtype)
            if key in keys:
                out[key] = z
        return out

    def reference_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        params = make_params(self.cfg, self.seed, self.dtype, self.device)
        return {part: {k: v.float() for k, v in ps.items()} for part, ps in params.items()}

    controls = ("tf32",)

    def check(self, records: List[dict], control: Optional[str] = None) -> List[dict]:
        """The worst of each number over the sampled requests. With control
        "tf32" the reference computed with TF32 on stands in the program's
        place (the control that has to come out not correct)."""
        keys = self.sample(records)
        params, noise = self.reference_params(), self.noises(set(keys))
        worst: Dict[str, float] = {}
        for k in keys:
            audio, lengths = self.requests[k % len(self.requests)]
            outputs = self.outputs[k]
            if control == "tf32":
                with precision(tf32=True):
                    outputs = reference_outputs(params, self.cfg, audio, lengths, noise[k], self.device)
            got = judge(params, self.cfg, audio, lengths, noise[k], outputs, self.device)
            for name, v in got.items():
                worst[name] = max(worst.get(name, 0.0), v)
        return [{"name": n, "value": worst[n], "limit": float(self.p["limits"][n])} for n in worst]


def reference_outputs(params, cfg: dict, audio: np.ndarray, lengths: np.ndarray, noise: torch.Tensor,
                      device, indices=None, vocode=None) -> dict:
    """The reference's own outputs for one request: front-end mel, indices,
    the decoder's mel (of `indices` where given, else of its own) and the
    waveform of that mel (of `vocode`, a mel, where given). float32
    arithmetic in the current precision."""
    cc = cfg["codec"]
    frames = torch.as_tensor(valid_frames(lengths, cc), device=device)
    with torch.no_grad():
        mel_in = ref_codec.log_mel(torch.from_numpy(audio).to(device), cc["sample_rate"], cc["n_mels"], cc["hop_length"])
        t = mel_frames(audio.shape[1], cc)
        frames = frames.clamp(max=t)
        own = ref_codec.encode(params["codec"], cc, mel_in[:, :t], frames)
        idx = own if indices is None else torch.as_tensor(indices, device=device).long()
        down = int(np.prod(cc["downsample_factor"]))
        mel_out = ref_codec.decode(params["codec"], cc, idx, frames // down, noise.float())
        wav = ref_bigvgan.vocode(params["vocoder"], cfg["vocoder"], mel_out if vocode is None else vocode)
    return {"mel_in": mel_in, "indices": own, "mel_out": mel_out, "wav": wav, "frames": frames}


def judge(params, cfg: dict, audio: np.ndarray, lengths: np.ndarray, noise: torch.Tensor, outputs: dict,
          device) -> Dict[str, float]:
    """The numbers compared for one request's `outputs` ({mel_in, indices,
    mel_out, wav}), against the reference recomputed from the raw inputs in
    float32 with TF32 off. The reference follows the program stage by stage:
    it decodes the outputs' own indices (indices are discrete: one flipped
    at a rounding boundary would move every later number), with the
    decoder's noise drawn again, and vocodes the outputs' own mel; each
    stage's input is checked by the number before it.
      mel_in        largest |front-end log-mel - reference| on valid frames
      fsq_mismatch  share of valid indices unlike the reference's
      mel_out       largest |decoder mel - reference| / largest |reference|
      wave          ||waveform - reference|| / ||reference|| on valid
                    samples."""
    cc = cfg["codec"]
    mel = outputs["mel_out"]
    mel = (mel if isinstance(mel, torch.Tensor) else torch.from_numpy(np.asarray(mel))).to(device).float()
    with precision(tf32=False):
        ref = reference_outputs(params, cfg, audio, lengths, noise, device, indices=outputs["indices"], vocode=mel)
    frames = ref["frames"].cpu().numpy()
    hop, down = cc["hop_length"], int(np.prod(cc["downsample_factor"]))
    mel_in_ref, mel_out_ref, wav_ref = (ref[k].float().cpu().numpy() for k in ("mel_in", "mel_out", "wav"))
    idx_ref = ref["indices"].cpu().numpy()
    got = {k: np.asarray(outputs[k] if not isinstance(outputs[k], torch.Tensor) else outputs[k].float().cpu().numpy())
           for k in ("mel_in", "indices", "mel_out", "wav")}
    d_in = d_out = m_out = 0.0
    e_wav = n_wav = 0.0
    miss = total = 0
    for b, f in enumerate(frames):
        d_in = max(d_in, float(np.abs(got["mel_in"][b, :f] - mel_in_ref[b, :f]).max(initial=0.0)))
        n = f // down
        miss += int((got["indices"][b, :, :n] != idx_ref[b, :, :n]).sum())
        total += idx_ref.shape[1] * n
        d_out = max(d_out, float(np.abs(got["mel_out"][b, :f] - mel_out_ref[b, :f]).max(initial=0.0)))
        m_out = max(m_out, float(np.abs(mel_out_ref[b, :f]).max(initial=0.0)))
        e_wav += float(np.square(got["wav"][b, :f * hop].astype(np.float64) - wav_ref[b, :f * hop]).sum())
        n_wav += float(np.square(wav_ref[b, :f * hop].astype(np.float64)).sum())
    return {"mel_in": d_in, "fsq_mismatch": miss / max(1, total),
            "mel_out": d_out / max(m_out, 1e-30), "wave": (e_wav / max(n_wav, 1e-30)) ** 0.5}
