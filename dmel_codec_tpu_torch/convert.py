"""JAX parameter trees -> this package's state_dicts.

The exact inverse of the JAX package's torch-checkpoint converters
(`models/codec_convert.codec_params_from_torch_state_dict` and
`models/bigvgan.params_from_torch_state_dict`): this package uses the
original torch reference's parameter names and layouts, so a reference
checkpoint loads into it directly, and a JAX tree reaches it through here.
Input leaves are array-likes (numpy, or jax arrays via np.asarray); output
values are CPU float tensors for `load_state_dict`.

Layouts: Dense [in, out] -> Linear [out, in] (or [out, in, 1] for the
reference's 1x1 convs); conv [k, in, out] -> [out, in, k]; transposed conv
[k, in, out] -> [in, out, k]; vmapped `rvqs` leading group axis ->
`rvqs.{g}`; 2-D conv [k_mel, k_time, in, out] -> [out, in, k_mel, k_time];
the discriminator's `conv_{i}` -> `blocks.{2i}`; quantizer up stage idx -> Sequential position n - 1 - idx;
`nn.Embed.embedding` -> `Embedding.weight`; the LM's `audio_projector`
DenseGeneral kernel [C, H, H_out] -> Linear [H_out, C * H], the order in
which the port flattens the codebook embeddings. A LoRA adapter tree keeps
its `a` [in, r] and `b` [r, out]; only the names change.

`reference_encoder_state_dict_from_jax` is the one bridge with no torch
original behind it: the port's `models/reference_encoder.ReferenceEncoder`
keeps the flax module's names (flax LayerNorm `scale` -> `weight`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dmel_codec_tpu_torch.models.bigvgan import BigVGANConfig
from dmel_codec_tpu_torch.models.lm import SlowFastLMConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(p: dict) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def _conv1x1(p: dict) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.asarray(p["kernel"]).T[:, :, None]), "bias": _t(p["bias"])}


def _conv(p: dict) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.transpose(p["kernel"], (2, 1, 0))), "bias": _t(p["bias"])}


def _conv_transpose(p: dict) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.transpose(p["kernel"], (1, 2, 0))), "bias": _t(p["bias"])}


def _put(sd: dict, prefix: str, entries: Dict[str, torch.Tensor]) -> None:
    for k, v in entries.items():
        sd[f"{prefix}.{k}"] = v


def _wavenet(sd: dict, prefix: str, p: dict) -> None:
    for name in ("input_projection", "skip_projection", "output_projection"):
        if name in p:
            _put(sd, f"{prefix}.{name}.conv", _conv1x1(p[name]))
    i = 0
    while f"layer_{i}" in p:
        lp, out = p[f"layer_{i}"], f"{prefix}.residual_layers.{i}"
        _put(sd, f"{out}.conv_layer.conv", _conv(lp["conv"]))
        _put(sd, f"{out}.output_projection.conv", _conv1x1(lp["output_projection"]))
        if "condition_projection" in lp:
            _put(sd, f"{out}.condition_projection.conv", _conv1x1(lp["condition_projection"]))
        i += 1


def _convnext(sd: dict, prefix: str, p: dict) -> None:
    _put(sd, f"{prefix}.dwconv", _conv(p["dwconv"]))
    _put(sd, f"{prefix}.norm", {"weight": _t(p["norm"]["weight"]), "bias": _t(p["norm"]["bias"])})
    _put(sd, f"{prefix}.pwconv1", _linear(p["pwconv1"]))
    _put(sd, f"{prefix}.pwconv2", _linear(p["pwconv2"]))
    sd[f"{prefix}.gamma"] = _t(p["gamma"])


def codec_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """DMelCodec flax params -> `dmel_codec_tpu_torch.models.codec.DMelCodec` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _wavenet(sd, "encoder", params["encoder"])
    _wavenet(sd, "decoder", params["decoder"])
    _put(sd, "quality_projection", _linear(params["quality_projection"]))

    q = params["quantizer"]
    n = sum(1 for k in q if k.startswith("downsample_") and k.endswith("_conv"))
    for idx in range(n):
        _put(sd, f"quantizer.downsample.{idx}.0", _conv(q[f"downsample_{idx}_conv"]))
        _convnext(sd, f"quantizer.downsample.{idx}.1", q[f"downsample_{idx}_block"])
        s = n - 1 - idx  # the reference builds the up stages in reversed order
        _put(sd, f"quantizer.upsample.{s}.0", _conv_transpose(q[f"upsample_{idx}_convt"]))
        _convnext(sd, f"quantizer.upsample.{s}.1", q[f"upsample_{idx}_block"])
    rvqs = q["residual_fsq"]["rvqs"]
    for name in ("project_in", "project_out"):
        kernel, bias = np.asarray(rvqs[name]["kernel"]), np.asarray(rvqs[name]["bias"])
        for g in range(kernel.shape[0]):
            _put(
                sd,
                f"quantizer.residual_fsq.rvqs.{g}.{name}",
                _linear({"kernel": kernel[g], "bias": bias[g]}),
            )
    return sd


def _wn(sd: dict, prefix: str, p: dict, transposed: bool) -> None:
    v = np.asarray(p["v"])  # [k, in, out]
    sd[f"{prefix}.weight_v"] = _t(np.transpose(v, (1, 2, 0) if transposed else (2, 1, 0)))
    sd[f"{prefix}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _act(sd: dict, prefix: str, p: dict) -> None:
    for name in ("alpha", "beta"):
        if name in p:
            sd[f"{prefix}.act.{name}"] = _t(p[name])


def bigvgan_state_dict_from_jax(params: dict, cfg: BigVGANConfig) -> Dict[str, torch.Tensor]:
    """BigVGAN flax params -> `dmel_codec_tpu_torch.models.bigvgan.BigVGAN` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _wn(sd, "conv_pre", params["conv_pre"], transposed=False)
    _wn(sd, "conv_post", params["conv_post"], transposed=False)
    _act(sd, "activation_post", params["act_post"])
    for i in range(len(cfg.upsample_rates)):
        _wn(sd, f"ups.{i}.0", params[f"up_{i}"], transposed=True)
        for j, dils in enumerate(cfg.resblock_dilation_sizes):
            n = i * cfg.num_kernels + j
            blk, out = params[f"resblock_{n}"], f"resblocks.{n}"
            for jj in range(len(dils)):
                if cfg.resblock == "1":
                    _wn(sd, f"{out}.convs1.{jj}", blk[f"conv1_{jj}"], transposed=False)
                    _wn(sd, f"{out}.convs2.{jj}", blk[f"conv2_{jj}"], transposed=False)
                else:  # AMPBlock2: one conv per activation
                    _wn(sd, f"{out}.convs.{jj}", blk[f"conv_{jj}"], transposed=False)
            for a in range((2 if cfg.resblock == "1" else 1) * len(dils)):
                _act(sd, f"{out}.activations.{a}", blk[f"act_{a}"])
    return sd


def discriminator_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """MelDiscriminator flax params ->
    `dmel_codec_tpu_torch.models.discriminator.MelDiscriminator` state_dict:
    the inverse of the JAX package's `discriminator_params_from_torch`."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(params)):
        p, out = params[f"conv_{i}"], f"blocks.{2 * i}"
        sd[f"{out}.weight_v"] = _t(np.transpose(p["v"], (3, 2, 0, 1)))
        sd[f"{out}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1, 1))
        sd[f"{out}.bias"] = _t(p["bias"])
    return sd


def codec_train_state_from_jax(trainer, gen_params: dict, disc_params: dict):
    """A `CodecTrainState` of `trainer` (a
    `dmel_codec_tpu_torch.train.codec_trainer.CodecTrainer`) at step 0 that
    holds the JAX trainer's `gen_params` and `disc_params` (numpy trees),
    with fresh optimizer states."""
    state = trainer.init_state(0)
    trainer.codec.load_state_dict(codec_state_dict_from_jax(gen_params))
    trainer.discriminator.load_state_dict(discriminator_state_dict_from_jax(disc_params))
    return state


def _dense(p: dict) -> Dict[str, torch.Tensor]:
    """Dense with or without a bias."""
    out = {"weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def decoder_state_dict_from_jax(params: dict, num_layers: int) -> Dict[str, torch.Tensor]:
    """Decoder flax params (`layers_{i}`, not scanned) ->
    `dmel_codec_tpu_torch.models.transformer.Decoder` state_dict, which has
    HF Qwen2Model's names: the inverse of the JAX package's
    `decoder_params_from_torch`."""
    sd: Dict[str, torch.Tensor] = {"norm.weight": _t(params["norm"]["weight"])}
    for i in range(num_layers):
        lp, out = params[f"layers_{i}"], f"layers.{i}"
        for name in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{out}.{name}.weight"] = _t(lp[name]["weight"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _put(sd, f"{out}.self_attn.{name}", _dense(lp["self_attn"][name]))
        for name in ("gate_proj", "up_proj", "down_proj"):
            _put(sd, f"{out}.mlp.{name}", _dense(lp["mlp"][name]))
    return sd


def lm_state_dict_from_jax(params: dict, cfg: SlowFastLMConfig) -> Dict[str, torch.Tensor]:
    """ChatMusicLM flax params -> `dmel_codec_tpu_torch.models.lm.ChatMusicLM` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("text_embed", "slow_audio_embed", "fast_audio_embed"):
        sd[f"{name}.weight"] = _t(params[name]["embedding"])
    kernel = np.asarray(params["audio_projector"]["kernel"])  # [C, H, H_out]
    sd["audio_projector.weight"] = _t(kernel.reshape(-1, kernel.shape[-1]).T)
    sd["fast_pre_norm.weight"] = _t(params["fast_pre_norm"]["weight"])
    for name in ("fast_projector", "text_head", "audio_head"):
        _put(sd, name, _dense(params[name]))
    for name, tcfg in (("slow_decoder", cfg.slow), ("fast_decoder", cfg.fast)):
        _put(sd, name, decoder_state_dict_from_jax(params[name], tcfg.num_layers))
    return sd


def lora_from_jax(lora: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA adapter tree ({"slow_decoder/layers_0/self_attn/q_proj/kernel":
    {"a", "b"}}) -> `dmel_codec_tpu_torch.train.lora`'s tree, keyed by this
    package's parameter names; `a` [in, r] and `b` [r, out] as they are."""
    out = {}
    for path, ab in lora.items():
        parts = path.split("/")
        if parts[-1] != "kernel":
            raise ValueError(f"LoRA target {path!r} is not a Dense kernel")
        parts = [p.replace("layers_", "layers.") for p in parts[:-1]] + ["weight"]
        out[".".join(parts)] = {"a": _t(ab["a"]), "b": _t(ab["b"])}
    return out


def reference_encoder_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """ReferenceEncoder flax params ->
    `dmel_codec_tpu_torch.models.reference_encoder.ReferenceEncoder` state_dict."""
    sd: Dict[str, torch.Tensor] = {"latent": _t(params["latent"])}
    _wavenet(sd, "wavenet", params["wavenet"])
    for name in ("q", "kv", "proj", "mlp_0", "mlp_1", "output_projection_attn"):
        _put(sd, name, _linear(params[name]))
    for name in ("q_norm", "k_norm", "norm"):
        _put(sd, name, {"weight": _t(params[name]["scale"]), "bias": _t(params[name]["bias"])})
    return sd
