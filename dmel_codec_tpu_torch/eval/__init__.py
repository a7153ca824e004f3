from dmel_codec_tpu_torch.eval.metrics import (
    codebook_usage_entropy,
    mel_l1_distance,
    si_snr,
    stoi,
    wer,
)

__all__ = ["mel_l1_distance", "si_snr", "stoi", "wer", "codebook_usage_entropy"]
