"""Manifest preparation entry point (port of `dmel_codec_tpu/cli/preprocess.py`;
the same arguments). WAVs under a directory -> a cut manifest for the
training CLIs; prints the duration stats as JSON. Builds no model.

    python -m dmel_codec_tpu_torch.cli.preprocess --wav-dir /data/wavs \
        --out train_cuts.jsonl.gz --window 3.0 --min-duration 3.0
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build cut manifests from WAVs")
    parser.add_argument("--wav-dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--transcripts", default=None, help="tsv: id<TAB>text")
    parser.add_argument("--window", type=float, default=None)
    parser.add_argument("--min-duration", type=float, default=None)
    parser.add_argument("--max-duration", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from dmel_codec_tpu_torch.data.preprocess import cuts_from_dir, prepare_manifests

    transcripts = None
    if args.transcripts:
        transcripts = {}
        with open(args.transcripts) as f:
            for line in f:
                if "\t" in line:
                    k, v = line.rstrip("\n").split("\t", 1)
                    transcripts[k] = v

    cuts = cuts_from_dir(args.wav_dir, transcripts)
    stats = prepare_manifests(
        cuts,
        args.out,
        window_seconds=args.window,
        min_duration=args.min_duration,
        max_duration=args.max_duration,
        shuffle_seed=args.seed,
    )
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
