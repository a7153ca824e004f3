"""Codec evaluation harness: batch loop + metric aggregation (port of
`dmel_codec_tpu/eval/evaluation.py`).

Iterate a test set, reconstruct through a codec adapter (eval/codecs.py),
compute per-batch metrics, aggregate means: the JAX harness's columns and
means. Native metrics (mel L1, SI-SNR, STOI, F0 corr, codebook entropy)
always run; ASR-WER / PESQ / speaker similarity attach when their models
are available (eval/external.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from dmel_codec_tpu_torch.data.audio import resample_audio
from dmel_codec_tpu_torch.eval import metrics as M
from dmel_codec_tpu_torch.eval.external import WhisperASR, asr_wer


@dataclasses.dataclass
class EvalResult:
    means: Dict[str, float]
    per_batch: List[Dict[str, float]]


class Evaluation:
    def __init__(
        self,
        codec,
        asr: Optional[WhisperASR] = None,
        compute_pesq: bool = True,
        compute_spk_sim: bool = False,
        spk_params=None,
        spk_weights_path: Optional[str] = None,
        device="cuda",
    ):
        """`spk_params`: an `eval/ecapa.ECAPA_TDNN`; `spk_weights_path`: a
        speechbrain `embedding_model.ckpt` loaded onto `device`, where the
        mel-L1 transform runs too (the codec's own device, as the CLI sets it).
        """
        self.codec = codec
        self.asr = asr
        self.compute_pesq = compute_pesq
        self.device = device
        # the spk-sim column runs natively when an ECAPA model / a local
        # checkpoint is supplied (eval/ecapa.py); speechbrain otherwise
        self.compute_spk_sim = compute_spk_sim or spk_params is not None
        self.spk_params = spk_params
        if self.spk_params is None and spk_weights_path is not None:
            from dmel_codec_tpu_torch.eval.ecapa import load_ecapa_checkpoint

            self.spk_params = load_ecapa_checkpoint(spk_weights_path, device)
            self.compute_spk_sim = True

    def step(self, batch: Dict) -> Dict[str, float]:
        """batch: {'audios' [B, T], 'audio_lengths' [B], 'texts': [...]}"""
        gt = np.asarray(batch["audios"], np.float32)
        lengths = np.asarray(batch["audio_lengths"])
        sr = self.codec.sample_rate

        indices, idx_lengths = self.codec.encode(gt, batch.get("audio_lengths"))
        rec, rec_mel = self.codec.decode(indices, idx_lengths)

        out: Dict[str, float] = {}
        n = min(gt.shape[-1], rec.shape[-1]) if rec.size else 0
        if not n:
            # vocoder-less adapter: compare in the mel domain directly
            with torch.no_grad():
                gt_mel = self.codec.mel_tf(torch.from_numpy(gt).to(self.codec.device)).cpu().numpy()
            f = min(gt_mel.shape[1], rec_mel.shape[1])
            out["mel_l1"] = float(
                np.abs(gt_mel[:, :f] - np.asarray(rec_mel)[:, :f]).mean()
            )
        if n:
            g, r = gt[..., :n], rec[..., :n]
            out["si_snr"] = M.si_snr(g, r)
            out["mel_l1"] = M.mel_l1_distance(g, r, sr, self.device)
            stois = [M.stoi(g[i, : lengths[i]], r[i, : lengths[i]], sr) for i in range(len(g))]
            stois = [s for s in stois if np.isfinite(s)]
            if stois:
                out["stoi"] = float(np.mean(stois))
            f0s = [M.f0_corr(g[i, : lengths[i]], r[i, : lengths[i]], sr) for i in range(len(g))]
            f0s = [f for f in f0s if np.isfinite(f)]
            if f0s:
                out["f0_corr"] = float(np.mean(f0s))

        entropy = M.codebook_usage_entropy(indices, self.codec.config.codebook_size)
        out["codebook_entropy_mean"] = float(np.mean(entropy))

        if self.asr is not None and n and batch.get("texts"):
            gt16 = [resample_audio(gt[i, : lengths[i]], sr, 16000) for i in range(len(gt))]
            rec16 = [resample_audio(rec[i, : lengths[i]], sr, 16000) for i in range(len(gt))]
            wer_gt, wer_rec = asr_wer(self.asr, gt16, rec16, list(batch["texts"]))
            out["wer_gt"], out["wer_rec"] = wer_gt, wer_rec

        if self.compute_pesq and n:
            from dmel_codec_tpu_torch.eval.external import pesq_wb_16k

            vals = []
            for i in range(len(gt)):
                g16 = resample_audio(gt[i, : lengths[i]], sr, 16000)
                r16 = resample_audio(rec[i, : lengths[i]], sr, 16000)
                vals.append(pesq_wb_16k(g16, r16))
            out["pesq"] = float(np.mean(vals))

        if self.compute_spk_sim and n:
            from dmel_codec_tpu_torch.eval.external import speaker_similarity

            sims = []
            for i in range(len(gt)):
                g16 = resample_audio(gt[i, : lengths[i]], sr, 16000)
                r16 = resample_audio(rec[i, : lengths[i]], sr, 16000)
                sims.append(
                    speaker_similarity(g16, r16, native_params=self.spk_params, device=self.device)
                )
            out["spk_sim"] = float(np.mean(sims))
        return out

    def run(self, batches: Iterable[Dict]) -> EvalResult:
        per_batch = [self.step(b) for b in batches]
        keys = {k for b in per_batch for k in b}
        means = {
            k: float(np.mean([b[k] for b in per_batch if k in b])) for k in keys
        }
        return EvalResult(means=means, per_batch=per_batch)
