"""Code or vocode a long recording window by window (models/streaming.py).

    python -m dmel_codec_tpu_torch.cli.stream_codec --in long.wav --tokens-out long.npy
    python -m dmel_codec_tpu_torch.cli.stream_codec --tokens-in long.npy --out long_out.wav
    python -m dmel_codec_tpu_torch.cli.stream_codec --in long.wav --out roundtrip.wav

WAV in -> log-mel -> `chunked_encode` -> tokens (`.npy`, [1, G*R, L]) and/or
tokens -> `chunked_decode` -> `chunked_vocode` -> WAV out. The host holds
the clip, the device one window. `--codec-ckpt` is a codec checkpoint
directory (cli/common.py), `--vocoder-dir` a BigVGAN release directory
(config.json + bigvgan_generator.pt); without them the weights are random,
from `--seed`. Optional `--config` YAML sections `model:` (DMelCodecConfig)
and `vocoder:` (BigVGANConfig) size the models. Runs on `--device`
(default cuda).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from scipy.io import wavfile

from dmel_codec_tpu_torch.cli.common import load_codec_adapter
from dmel_codec_tpu_torch.data.audio import load_audio
from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram
from dmel_codec_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, FusedBigVGAN, from_pretrained
from dmel_codec_tpu_torch.models.codec import DMelCodec, DMelCodecConfig
from dmel_codec_tpu_torch.models.streaming import (
    DEFAULT_HALO_FRAMES,
    chunked_decode,
    chunked_encode,
    chunked_vocode,
)
from dmel_codec_tpu_torch.utils.config import dataclass_from_dict, load_yaml
from dmel_codec_tpu_torch.utils.logging import RankedLogger
from dmel_codec_tpu_torch.utils.precision import strict_float32

log = RankedLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser(description="chunked codec encode / decode / vocode")
    parser.add_argument("--in", dest="wav_in", default=None, help="WAV to encode")
    parser.add_argument("--tokens-in", default=None, help=".npy of indices [1, G*R, L] to decode")
    parser.add_argument("--tokens-out", default=None, help="where to save the encoded indices")
    parser.add_argument("--out", default=None, help="WAV to write from the tokens")
    parser.add_argument("--config", default=None)
    parser.add_argument("--codec-ckpt", default=None)
    parser.add_argument("--vocoder-dir", default=None)
    parser.add_argument("--chunk-frames", type=int, default=1024, help="codec chunk, in mel frames")
    parser.add_argument("--halo-frames", type=int, default=DEFAULT_HALO_FRAMES)
    parser.add_argument("--use-v1", action="store_true", help="whole-stage kernel K2-v1 where it holds a stage")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    strict_float32()  # no TF32: the JAX package's float32 contract (utils/precision.py)
    if (args.wav_in is None) == (args.tokens_in is None):
        parser.error("give exactly one of --in and --tokens-in")
    if args.out is None and args.tokens_out is None:
        parser.error("nothing to write: give --tokens-out and/or --out")
    device = torch.device(args.device)
    cfg = load_yaml(args.config) if args.config else {}
    torch.manual_seed(args.seed)

    codec_cfg = dataclass_from_dict(DMelCodecConfig, cfg.get("model"))
    if args.codec_ckpt:
        codec = load_codec_adapter(args.codec_ckpt, codec_cfg, device=device).codec
    else:
        codec = DMelCodec(codec_cfg).to(device).eval()
    down = codec_cfg.downsample_total

    if args.wav_in:
        audio = load_audio(args.wav_in, target_sr=codec_cfg.sample_rate)
        mel_tf = LogMelSpectrogram(
            sample_rate=codec_cfg.sample_rate, hop_length=codec_cfg.hop_length, n_mels=codec_cfg.n_mels
        )
        mels = mel_tf(torch.from_numpy(audio)[None]).numpy()
        indices = chunked_encode(codec, mels, args.chunk_frames, args.halo_frames, device=device)
        log.info(f"{len(audio) / codec_cfg.sample_rate:.2f} s -> {mels.shape[1]} frames -> {indices.shape[2]} tokens")
        if args.tokens_out:
            np.save(args.tokens_out, indices)
    else:
        indices = np.load(args.tokens_in)

    if args.out:
        vocoder = from_pretrained(args.vocoder_dir) if args.vocoder_dir else BigVGAN(
            dataclass_from_dict(BigVGANConfig, cfg.get("vocoder"))
        )
        fused = FusedBigVGAN(vocoder.to(device).eval(), use_v2=not args.use_v1)
        mel = chunked_decode(
            codec, indices, chunk_tokens=args.chunk_frames // down, halo_tokens=args.halo_frames // down,
            seed=args.seed, device=device,
        )
        wav = chunked_vocode(fused, mel, device=device)
        wavfile.write(args.out, codec_cfg.sample_rate, wav[0])
        log.info(f"wrote {args.out} ({wav.shape[1] / codec_cfg.sample_rate:.2f} s)")


if __name__ == "__main__":
    main()
