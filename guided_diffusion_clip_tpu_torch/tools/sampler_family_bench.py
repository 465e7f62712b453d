"""The sampler families on the card: a guided chain's rate under ancestral,
DDIM and DPM-Solver++(2M) sampling.

    python -m guided_diffusion_clip_tpu_torch.tools.sampler_family_bench [--device cuda]

Counterpart of ``tools/sampler_family_bench.py``: ADM-G 256 and its
classifier (``_timing.make_models``, N(0, 0.02) weights; throughput does not
depend on them), one chain a spec of ``SFB_SAMPLERS``, run twice, a warm-up
and then the timed run (CUDA events). A spec is a loop and a respacing
(``parse_sampler``): ``ddim25`` the DDIM loop over ``ddim25``, ``dpm25``
DPM-Solver++(2M) over 25 steps, ``ancestral250`` the ancestral loop over 250.

Environment, as the JAX tool's: ``SFB_BATCH`` (16), ``SFB_IMAGE_SIZE``
(256), ``SFB_SAMPLERS`` ("ddim25;dpm25;ancestral250"), ``SFB_CONV_IMPL``
(int8, the default, or xla), ``SFB_FP16`` (1), ``SFB_CH`` (256 at 256 px,
else 192), ``SFB_USE_CHECKPOINT`` (0; 1 recomputes each block's activations
in the UNet's backward, which only ``clip_x0`` runs), ``SFB_GUIDANCE_CACHE``
(0; N > 1 recomputes the guidance gradient one step in N), and
``SFB_GUIDANCE``:

    classifier  the classifier's gradient (``classifier_cond_fn``), scale 1
    clip        the cosine similarity's gradient through a random ViT-B/32
                (``clip_guidance_cond_fn``, seed 2) to a random target
                embedding (``RandomState(3)``), scale 100, at the noisy x
    clip_x0     the same at the UNet's x0 prediction: a UNet forward and
                backward a step inside the gradient (under int8 the UNet's
                forward there keeps its graph, as ``clip_guided_sample``
                runs it)
    cfg         classifier-free guidance, ``SFB_CFG_SCALE`` (2.0), with class
                0 standing in for the null label (``{"y": 0}``: throughput
                only, no trained null class): the doubled batch
                (``cfg_model_fn``), or with ``SFB_CFG_CACHE`` N > 1 the
                unconditional branch refreshed one step in N
                (``cfg_cached_model_fn``)

One JSON line with the JAX tool's keys, per spec ``secs_per_chain``,
``samples_per_min_per_chip`` and ``steps``, plus per spec
``peak_memory_gib`` (the card's peak allocation over the spec's two runs)
and ``card``. ``--device cpu`` rehearses the tool: times but no rate and no
memory.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..diffusion.guidance import cached_cond_fn, cfg_cached_model_fn, cfg_cached_state0, cfg_model_fn
from ..models.clip_vit import CLIPConfig, CLIPVisionEncoder, clip_guidance_cond_fn
from ..models.unet import CONV_IMPLS
from ..utils.script_util import create_gaussian_diffusion
from ._chains import classifier_chain, counted_unet, labels, runner
from ._timing import built_on, card_label, make_models, on_card_defaults, per_min, pick_device, timed_twice

GUIDANCES = ("classifier", "clip", "clip_x0", "cfg")
CLIP_SCALE = 100.0
NULL = {"y": 0}


def parse_sampler(spec: str) -> tuple:
    """'ddim25' -> ('ddim', 'ddim25'); 'dpm25' -> ('dpm', '25');
    'ancestral250' -> ('ancestral', '250')."""
    for prefix in ("ancestral", "ddim", "dpm"):
        if spec.startswith(prefix):
            n = spec[len(prefix):]
            return prefix, f"ddim{n}" if prefix == "ddim" else n
    raise ValueError(f"unknown sampler spec: {spec}")


def settings() -> dict:
    size = int(os.environ.get("SFB_IMAGE_SIZE", 256))
    s = {
        "batch": int(os.environ.get("SFB_BATCH", 16)),
        "size": size,
        "specs": [x for x in os.environ.get("SFB_SAMPLERS", "ddim25;dpm25;ancestral250").split(";") if x.strip()],
        "conv_impl": os.environ.get("SFB_CONV_IMPL", "int8"),
        "fp16": os.environ.get("SFB_FP16", "1") == "1",
        "channels": int(os.environ.get("SFB_CH", 256 if size == 256 else 192)),
        "use_checkpoint": os.environ.get("SFB_USE_CHECKPOINT", "0") == "1",
        "guidance": os.environ.get("SFB_GUIDANCE", "classifier"),
        "guidance_cache": int(os.environ.get("SFB_GUIDANCE_CACHE", 0)),
        "cfg_scale": float(os.environ.get("SFB_CFG_SCALE", 2.0)),
        "cfg_cache": int(os.environ.get("SFB_CFG_CACHE", 0)),
    }
    if s["conv_impl"] not in CONV_IMPLS:
        raise SystemExit(f"SFB_CONV_IMPL {s['conv_impl']!r}: choose from {CONV_IMPLS}")
    if s["guidance"] not in GUIDANCES:
        raise SystemExit(f"SFB_GUIDANCE {s['guidance']!r}: choose from {GUIDANCES}")
    for spec in s["specs"]:
        parse_sampler(spec)
    return s


def clip_models(device, cfg: CLIPConfig | None = None) -> tuple:
    """(``cfg``'s image tower, ViT-B/32 by default, with N(0, 0.02) weights
    from seed 2, the target embedding from ``RandomState(3)``)."""
    cfg = cfg or CLIPConfig()
    vision = built_on(lambda: CLIPVisionEncoder(cfg), device, 2).requires_grad_(False)
    target = torch.from_numpy(np.random.RandomState(3).standard_normal(cfg.embed_dim).astype(np.float32)).to(device)
    return vision, target


def make_chain(kind: str, diffusion, model, classifier, classes, guidance: str = "classifier", *,
               guidance_cache: int = 0, vision=None, target=None, cfg_scale: float = 2.0, cfg_cache: int = 0):
    """``run(noise=None, step_noise=None) -> samples``, one chain of ``kind``'s
    loop (``parse_sampler``) under ``guidance``, as the JAX tool composes it;
    ``run.calls`` counts the networks' calls (``unet_full``, ``classifier``,
    ``clip``)."""
    loop = {"ancestral": diffusion.p_sample_loop, "ddim": diffusion.ddim_sample_loop,
            "dpm": diffusion.dpm_solver_pp_2m_loop}[kind]
    if guidance == "classifier":
        return classifier_chain(loop, model, classifier, classes, guidance_cache=guidance_cache)
    device, batch = classes.device, classes.shape[0]
    size = model.config.image_size
    shape = (batch, 3, size, size)
    calls = {"unet_full": 0, "unet_shallow": 0, "classifier": 0, "clip": 0}
    unet = counted_unet(model, calls)
    model_fn, model_state0, cond_fn, cond_state0 = unet, None, None, None
    if guidance == "cfg" and cfg_cache > 1:
        model_fn = cfg_cached_model_fn(unet, cfg_scale, NULL, cfg_cache)
        model_state0 = cfg_cached_state0((batch, model.config.out_channels, size, size), device=device)
    elif guidance == "cfg":
        model_fn = cfg_model_fn(unet, cfg_scale, NULL)
    else:
        def embed(pixels):
            calls["clip"] += 1
            return vision(pixels)

        cond_fn = clip_guidance_cond_fn(
            embed, target, CLIP_SCALE, clip_image_size=vision.config.image_size, sched=diffusion.sched,
            mean_type=diffusion.mean_type, var_type=diffusion.var_type, model_fn=unet,
            use_pred_xstart=guidance == "clip_x0")
        if guidance_cache > 1:
            cond_fn, cond_state0 = cached_cond_fn(cond_fn, guidance_cache, shape, device=device)

    run = runner(loop, model_fn, classes, shape, cond_fn=cond_fn, model_state0=model_state0,
                 cond_state0=cond_state0)
    run.calls = calls
    return run


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    s = settings()
    device = pick_device(args.device)
    card = card_label(device)
    on_card_defaults(device)
    model, classifier, _ = make_models(s["size"], s["conv_impl"], s["channels"], use_checkpoint=s["use_checkpoint"], fp16=s["fp16"], device=device)
    # per-block recomputation acts in train mode only; dropout is 0, so the forward is the same
    model.train(s["use_checkpoint"])
    vision, target = clip_models(device) if s["guidance"] in ("clip", "clip_x0") else (None, None)
    B, classes = s["batch"], labels(s["batch"], device)
    on_card = device.type == "cuda"
    results = {}
    for spec in s["specs"]:
        kind, respacing = parse_sampler(spec)
        diffusion = create_gaussian_diffusion(steps=1000, learn_sigma=True, noise_schedule="linear",
                                              timestep_respacing=respacing)
        chain = make_chain(kind, diffusion, model, classifier, classes, s["guidance"],
                           guidance_cache=s["guidance_cache"], vision=vision, target=target,
                           cfg_scale=s["cfg_scale"], cfg_cache=s["cfg_cache"])
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        out, secs = timed_twice(chain, device)
        if not bool(torch.isfinite(out).all()):
            raise SystemExit(f"{spec}: the samples are not finite")
        results[spec] = {
            "secs_per_chain": secs, "samples_per_min_per_chip": per_min(B, secs, device),
            "steps": diffusion.num_timesteps,
            "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30 if on_card else None,
        }
        print(f"[sfb] {spec} ({s['guidance']}): {results[spec]}, network calls over both runs {chain.calls} "
              f"({card})", flush=True)
    results["card"] = card
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
