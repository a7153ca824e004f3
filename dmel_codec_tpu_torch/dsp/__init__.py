"""Log-mel front end."""

from dmel_codec_tpu_torch.dsp.mel import hann_window, mel_filterbank
from dmel_codec_tpu_torch.dsp.spectrogram import LogMelSpectrogram, log_mel_spectrogram

__all__ = [
    "hann_window",
    "mel_filterbank",
    "LogMelSpectrogram",
    "log_mel_spectrogram",
]
