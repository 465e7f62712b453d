"""Config/factory layer: defaults dicts, model+diffusion factories, CLI glue.

Counterpart of ``guided_diffusion_clip_tpu/utils/script_util.py``: the
defaults and factories of the CLIP UNet, the upstream UNet, the classifier
and the SR models, and the CLIs' flag handling. The flag surface is the
reference's; ``use_fp16`` and ``classifier_use_fp16`` map to a bf16 torso.
NUM_CLASSES = 512: the fork repurposes the class count as the CLIP embedding
dimension (the upstream UNet and the classifier keep 1000 ImageNet classes).
The factories take ``conv_impl`` ("auto", "xla" or "int8", the JAX package's
``set_conv_impl``) as a constructor argument of the models.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import os

import torch

from ..diffusion.api import Diffusion
from ..diffusion.schedules import LossType, ModelMeanType, ModelVarType, build_schedule
from ..models.clip_models import SRImageModel_Feat, UNetModel_clip_feat
from ..models.unet import EncoderUNetModel, UNetConfig, UNetModel

NUM_CLASSES = 512


def diffusion_defaults():
    """Defaults for image and classifier training (reference script_util.py:12-25)."""
    return dict(
        learn_sigma=False,
        diffusion_steps=1000,
        noise_schedule="linear",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=False,
        rescale_timesteps=False,
        rescale_learned_sigmas=False,
    )


def classifier_defaults():
    """Defaults for classifier models (reference script_util.py:28-41)."""
    return dict(
        image_size=64,
        classifier_use_fp16=False,
        classifier_width=128,
        classifier_depth=2,
        classifier_attention_resolutions="32,16,8",
        classifier_use_scale_shift_norm=True,
        classifier_resblock_updown=True,
        classifier_pool="attention",
    )


def model_and_diffusion_defaults():
    """Defaults for image training (reference script_util.py:44-66)."""
    res = dict(
        image_size=64,
        num_channels=128,
        num_res_blocks=2,
        num_heads=4,
        num_heads_upsample=-1,
        num_head_channels=-1,
        attention_resolutions="16,8",
        channel_mult="",
        dropout=0.0,
        class_cond=False,
        use_checkpoint=False,
        use_scale_shift_norm=True,
        resblock_updown=False,
        use_fp16=False,
        use_new_attention_order=False,
    )
    res.update(diffusion_defaults())
    return res


def image_train_defaults():
    """The training flags of scripts/image_train.py:122-151, with their
    defaults; ``image_train`` adds the model's and the diffusion's."""
    return dict(
        data_dir="",
        data_dir_test="",
        clip_file_path="",
        clip_file_path_test="",
        main_path="",
        profile_dir="",  # a torch.profiler trace of steps 1-3 here
        param_sharding="replicated",  # "fsdp": FSDP2 (under torchrun)
        opt_impl="tree",  # "flat": the same fused AdamW; "zero1": ZeRO-1 (under torchrun)
        spatial_shard=0,  # S > 1: each image's rows over S ranks (torchrun, a multiple of S ranks)
        tensor_shard=0,  # T > 1: each activation's channels over T ranks (torchrun, a multiple of T ranks)
        ckpt_backend="flax",  # the per-kind checkpoint files (.pt here); "orbax": DCP directories
        train_conv_impl="xla",  # "int8": the int8 convs (K4, K5) in the forward, straight-through backward
        loss_weighting="",  # "min_snr_5": SNR-clipped loss re-weighting
        cond_dropout=0.0,  # > 0: drop conditioning per example (train for CFG)
        cfg_null_y=-1,  # reserved null class index for cond_dropout on y models
        schedule_sampler="uniform",
        lr=1e-4,
        weight_decay=0.0,
        lr_anneal_steps=0,
        batch_size=1,
        microbatch=-1,  # -1 disables microbatches
        ema_rate="0.9999",  # comma-separated list of EMA values
        log_interval=100,
        save_interval=5000,
        resume_checkpoint="",
        use_fp16=False,
        fp16_scale_growth=1e-3,
        val_batch_size=8,
    )


def classifier_and_diffusion_defaults():
    res = classifier_defaults()
    res.update(diffusion_defaults())
    return res


def default_channel_mult(image_size: int) -> tuple:
    """Per-resolution channel_mult presets (reference script_util.py:149-159)."""
    if image_size == 512:
        return (0.5, 1, 1, 2, 2, 4, 4)
    elif image_size == 256:
        return (1, 1, 2, 2, 4, 4)
    elif image_size == 128:
        return (1, 1, 2, 3, 4)
    elif image_size == 64:
        return (1, 2, 3, 4)
    raise ValueError(f"unsupported image size: {image_size}")


def parse_attention_resolutions(spec: str, image_size: int) -> tuple:
    """"32,16,8" -> downsample factors image_size // res (reference script_util.py:163-165)."""
    return tuple(image_size // int(res) for res in str(spec).split(","))


def _dtype(use_fp16: bool) -> torch.dtype:
    return torch.bfloat16 if use_fp16 else torch.float32


def create_model(
    image_size,
    num_channels,
    num_res_blocks,
    channel_mult="",
    learn_sigma=False,
    class_cond=False,
    use_checkpoint=False,
    attention_resolutions="16",
    num_heads=1,
    num_head_channels=-1,
    num_heads_upsample=-1,
    use_scale_shift_norm=False,
    dropout=0,
    resblock_updown=False,
    use_fp16=False,
    use_new_attention_order=False,
    conv_impl="auto",
) -> UNetModel:
    """The fork's default model: UNetModel_clip_feat (reference script_util.py:131-187)."""
    cfg = _model_config(
        image_size, num_channels, num_res_blocks, channel_mult, learn_sigma, class_cond,
        use_checkpoint, attention_resolutions, num_heads, num_head_channels, num_heads_upsample,
        use_scale_shift_norm, dropout, resblock_updown, use_new_attention_order,
    )
    return UNetModel_clip_feat(cfg, dtype=_dtype(use_fp16), conv_impl=conv_impl)


def create_upstream_model(*, use_fp16=False, conv_impl="auto", **kw) -> UNetModel:
    """Plain upstream UNetModel with a 1000-row class table (``nn.Embedding``),
    for the released ADM checkpoints that do not use CLIP embeddings; takes
    ``create_model``'s arguments."""
    cfg = dataclasses.replace(
        _model_config(**kw), variant="unet", label_emb_type="embedding",
        num_classes=1000 if kw.get("class_cond") else None,
    )
    return UNetModel(cfg, dtype=_dtype(use_fp16), conv_impl=conv_impl)


def _model_config(
    image_size,
    num_channels,
    num_res_blocks,
    channel_mult="",
    learn_sigma=False,
    class_cond=False,
    use_checkpoint=False,
    attention_resolutions="16",
    num_heads=1,
    num_head_channels=-1,
    num_heads_upsample=-1,
    use_scale_shift_norm=False,
    dropout=0,
    resblock_updown=False,
    use_new_attention_order=False,
) -> UNetConfig:
    if channel_mult == "":
        channel_mult = default_channel_mult(image_size)
    elif isinstance(channel_mult, str):
        channel_mult = tuple(int(m) for m in channel_mult.split(","))
    return UNetConfig(
        image_size=image_size,
        in_channels=3,
        model_channels=num_channels,
        out_channels=(3 if not learn_sigma else 6),
        num_res_blocks=num_res_blocks,
        attention_resolutions=parse_attention_resolutions(attention_resolutions, image_size),
        dropout=dropout,
        channel_mult=tuple(channel_mult),
        num_classes=(NUM_CLASSES if class_cond else None),
        use_checkpoint=use_checkpoint,
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown,
        use_new_attention_order=use_new_attention_order,
    )


def create_classifier(
    image_size,
    classifier_use_fp16,
    classifier_width,
    classifier_depth,
    classifier_attention_resolutions,
    classifier_use_scale_shift_norm,
    classifier_resblock_updown,
    classifier_pool,
    conv_impl="auto",
) -> EncoderUNetModel:
    """EncoderUNet classifier, 1000 classes, 64-channel heads (reference
    script_util.py:231-269)."""
    cfg = UNetConfig(
        image_size=image_size,
        in_channels=3,
        model_channels=classifier_width,
        out_channels=1000,
        num_res_blocks=classifier_depth,
        attention_resolutions=parse_attention_resolutions(classifier_attention_resolutions, image_size),
        channel_mult=default_channel_mult(image_size),
        num_head_channels=64,
        use_scale_shift_norm=classifier_use_scale_shift_norm,
        resblock_updown=classifier_resblock_updown,
    )
    return EncoderUNetModel(cfg, pool=classifier_pool, dtype=_dtype(classifier_use_fp16), conv_impl=conv_impl)


def create_gaussian_diffusion(
    *,
    steps=1000,
    learn_sigma=False,
    sigma_small=False,
    noise_schedule="linear",
    use_kl=False,
    predict_xstart=False,
    rescale_timesteps=False,
    rescale_learned_sigmas=False,
    timestep_respacing="",
) -> Diffusion:
    """Map flags to schedule + enums (reference script_util.py:392-430)."""
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    sched = build_schedule(
        steps=steps,
        noise_schedule=noise_schedule,
        timestep_respacing=timestep_respacing,
        rescale_timesteps=rescale_timesteps,
    )
    return Diffusion(
        sched=sched,
        mean_type=ModelMeanType.EPSILON if not predict_xstart else ModelMeanType.START_X,
        var_type=(
            (ModelVarType.FIXED_LARGE if not sigma_small else ModelVarType.FIXED_SMALL)
            if not learn_sigma
            else ModelVarType.LEARNED_RANGE
        ),
        loss_type=loss_type,
    )


def create_model_and_diffusion(
    image_size,
    class_cond,
    learn_sigma,
    num_channels,
    num_res_blocks,
    channel_mult,
    num_heads,
    num_head_channels,
    num_heads_upsample,
    attention_resolutions,
    dropout,
    diffusion_steps,
    noise_schedule,
    timestep_respacing,
    use_kl,
    predict_xstart,
    rescale_timesteps,
    rescale_learned_sigmas,
    use_checkpoint,
    use_scale_shift_norm,
    resblock_updown,
    use_fp16,
    use_new_attention_order,
    conv_impl="auto",
):
    """The model and its diffusion. Under ``with torch.device(device):`` the
    model's parameters are created there (for a model whose weights are loaded
    next, its initializer then runs on the card: seconds at ADM-256's widths
    on the host); the diffusion's tables stay on the host."""
    model = create_model(
        image_size,
        num_channels,
        num_res_blocks,
        channel_mult=channel_mult,
        learn_sigma=learn_sigma,
        class_cond=class_cond,
        use_checkpoint=use_checkpoint,
        attention_resolutions=attention_resolutions,
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        dropout=dropout,
        resblock_updown=resblock_updown,
        use_fp16=use_fp16,
        use_new_attention_order=use_new_attention_order,
        conv_impl=conv_impl,
    )
    with torch.device("cpu"):
        diffusion = create_gaussian_diffusion(
            steps=diffusion_steps,
            learn_sigma=learn_sigma,
            noise_schedule=noise_schedule,
            use_kl=use_kl,
            predict_xstart=predict_xstart,
            rescale_timesteps=rescale_timesteps,
            rescale_learned_sigmas=rescale_learned_sigmas,
            timestep_respacing=timestep_respacing,
        )
    return model, diffusion


def sr_model_and_diffusion_defaults():
    """SR defaults, pruned to ``sr_create_model_and_diffusion``'s arguments
    (reference script_util.py:272-280)."""
    res = model_and_diffusion_defaults()
    res["large_size"] = 128
    res["small_size"] = 64
    arg_names = inspect.getfullargspec(sr_create_model_and_diffusion)[0]
    return {k: v for k, v in res.items() if k in arg_names}


def sr_channel_mult(large_size: int) -> tuple:
    """The SR model's channel_mult by its output size (reference script_util.py:356-365)."""
    if large_size in (512, 256):
        return (1, 1, 2, 2, 4, 4)
    if large_size == 128:
        return (1, 1, 2, 3, 4)
    if large_size == 64:
        return (1, 2, 3, 4)
    raise ValueError(f"unsupported large size: {large_size}")


def sr_create_model(
    large_size,
    small_size,
    num_channels,
    num_res_blocks,
    learn_sigma,
    class_cond,
    use_checkpoint,
    attention_resolutions,
    num_heads,
    num_head_channels,
    num_heads_upsample,
    use_scale_shift_norm,
    dropout,
    resblock_updown,
    use_fp16,
    conv_impl="auto",
) -> UNetModel:
    """The fork's SR model, SRImageModel_Feat (reference script_util.py:337-389):
    6 input channels (x and img2), the CLIP delta as its label when ``class_cond``."""
    del small_size
    cfg = UNetConfig(
        image_size=large_size,
        in_channels=6,
        model_channels=num_channels,
        out_channels=(3 if not learn_sigma else 6),
        num_res_blocks=num_res_blocks,
        attention_resolutions=parse_attention_resolutions(attention_resolutions, large_size),
        dropout=dropout,
        channel_mult=sr_channel_mult(large_size),
        num_classes=(NUM_CLASSES if class_cond else None),
        use_checkpoint=use_checkpoint,
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown,
    )
    return SRImageModel_Feat(cfg, dtype=_dtype(use_fp16), conv_impl=conv_impl)


def sr_create_model_and_diffusion(
    large_size,
    small_size,
    class_cond,
    learn_sigma,
    num_channels,
    num_res_blocks,
    num_heads,
    num_head_channels,
    num_heads_upsample,
    attention_resolutions,
    dropout,
    diffusion_steps,
    noise_schedule,
    timestep_respacing,
    use_kl,
    predict_xstart,
    rescale_timesteps,
    rescale_learned_sigmas,
    use_checkpoint,
    use_scale_shift_norm,
    resblock_updown,
    use_fp16,
    conv_impl="auto",
):
    model = sr_create_model(
        large_size,
        small_size,
        num_channels,
        num_res_blocks,
        learn_sigma=learn_sigma,
        class_cond=class_cond,
        use_checkpoint=use_checkpoint,
        attention_resolutions=attention_resolutions,
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        dropout=dropout,
        resblock_updown=resblock_updown,
        use_fp16=use_fp16,
        conv_impl=conv_impl,
    )
    diffusion = create_gaussian_diffusion(
        steps=diffusion_steps,
        learn_sigma=learn_sigma,
        noise_schedule=noise_schedule,
        use_kl=use_kl,
        predict_xstart=predict_xstart,
        rescale_timesteps=rescale_timesteps,
        rescale_learned_sigmas=rescale_learned_sigmas,
        timestep_respacing=timestep_respacing,
    )
    return model, diffusion


def upstream_super_res(model: UNetModel, class_cond: bool) -> UNetModel:
    """The upstream cascade's SuperResModel at the SR factory's
    configuration: the ``super_res`` variant (x ++ upsampled ``low_res``)
    with a class table when ``class_cond``. ``super_res_train`` and
    ``super_res_sample`` re-dispatch to it, as the JAX scripts do: the fork's
    factory builds the img2 / CLIP-delta model, and their batches carry
    ``low_res``."""
    cfg = dataclasses.replace(model.config, variant="super_res", label_emb_type="embedding",
                              num_classes=model.config.num_classes if class_cond else None)
    return UNetModel(cfg, dtype=model.dtype, conv_impl=model.conv_impl)


def create_classifier_and_diffusion(
    image_size,
    classifier_use_fp16,
    classifier_width,
    classifier_depth,
    classifier_attention_resolutions,
    classifier_use_scale_shift_norm,
    classifier_resblock_updown,
    classifier_pool,
    learn_sigma,
    diffusion_steps,
    noise_schedule,
    timestep_respacing,
    use_kl,
    predict_xstart,
    rescale_timesteps,
    rescale_learned_sigmas,
):
    classifier = create_classifier(
        image_size,
        classifier_use_fp16,
        classifier_width,
        classifier_depth,
        classifier_attention_resolutions,
        classifier_use_scale_shift_norm,
        classifier_resblock_updown,
        classifier_pool,
    )
    diffusion = create_gaussian_diffusion(
        steps=diffusion_steps,
        learn_sigma=learn_sigma,
        noise_schedule=noise_schedule,
        use_kl=use_kl,
        predict_xstart=predict_xstart,
        rescale_timesteps=rescale_timesteps,
        rescale_learned_sigmas=rescale_learned_sigmas,
        timestep_respacing=timestep_respacing,
    )
    return classifier, diffusion


# ---------------------------------------------------------------------------
# CLI glue (reference script_util.py:433-477)
# ---------------------------------------------------------------------------


def add_dict_to_argparser(parser, default_dict):
    for k, v in default_dict.items():
        v_type = type(v)
        if v is None:
            v_type = str
        elif isinstance(v, bool):
            v_type = str2bool
        parser.add_argument(f"--{k}", default=v, type=v_type)
    parser.add_argument(
        "--config-file", dest="config_file", default=None, type=str,
        help="YAML config overlaid onto parsed args (YAML wins)",
    )
    parser.add_argument(
        "-d", "--description", dest="description", type=str, default="",
        help="free description of the run",
    )


def args_to_dict(args, keys):
    return {k: getattr(args, k) for k in keys}


def resolve_sampler(diffusion, args, *, honor_use_ddim=True):
    """Map a sampling CLI's flags to the diffusion loop function.

    ``--use_ddim`` picks DDIM vs ancestral; ``--sampler
    {ancestral,ddim,dpm++2m}`` overrides it.
    """
    loop = diffusion.p_sample_loop
    if honor_use_ddim and getattr(args, "use_ddim", False):
        loop = diffusion.ddim_sample_loop
    name = getattr(args, "sampler", "")
    if name:
        samplers = {
            "ancestral": diffusion.p_sample_loop,
            "ddim": diffusion.ddim_sample_loop,
            "dpm++2m": diffusion.dpm_solver_pp_2m_loop,
        }
        if name not in samplers:
            raise SystemExit(f"--sampler {name!r}: choose from {sorted(samplers)}")
        loop = samplers[name]
    return loop


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    elif v.lower() in ("no", "false", "f", "n", "0"):
        return False
    else:
        raise argparse.ArgumentTypeError("boolean value expected")


def parse_yaml(args):
    """Overlay a YAML config onto parsed args; list values append
    (reference script_util.py:465-477). A missing/None config file is a
    no-op, and ``yaml`` is imported only when a file is given."""
    cf = getattr(args, "config_file", None)
    if cf:
        import yaml

        if hasattr(cf, "read"):
            data = yaml.load(cf, yaml.SafeLoader)
        else:
            with open(cf) as f:
                data = yaml.load(f, yaml.SafeLoader)
        arg_dict = args.__dict__
        for key, value in (data or {}).items():
            if isinstance(value, list) and isinstance(arg_dict.get(key), list):
                arg_dict[key].extend(value)
            else:
                arg_dict[key] = value
    if hasattr(args, "config_file"):
        delattr(args, "config_file")
    return args


def load_folder_path_parse(args):
    """Resolve ``args.model_path`` from a run-folder fragment and ``load_file``
    (JAX ``utils/script_util.py::load_folder_path_parse``, which reconstructs
    the reference's unshipped helper): ``--f <fragment>`` picks the run
    directory under ``main_path`` whose name contains the fragment (the last
    in sorted order, so the newest timestamped run), ``load_file`` names the
    checkpoint inside it, and the result goes to ``args.model_path``. Returns
    the folder's name, or None without a fragment or ``main_path``."""
    fragment = getattr(args, "f", None) or getattr(args, "folder", None)
    main_path = getattr(args, "main_path", None)
    load_file = getattr(args, "load_file", None)
    if not fragment or not main_path:
        return None
    candidates = sorted(
        d for d in os.listdir(main_path)
        if fragment in d and os.path.isdir(os.path.join(main_path, d))
    )
    if not candidates:
        raise FileNotFoundError(f"no run folder matching {fragment!r} under {main_path}")
    folder = candidates[-1]
    if load_file:
        args.model_path = os.path.join(main_path, folder, load_file)
    return folder
