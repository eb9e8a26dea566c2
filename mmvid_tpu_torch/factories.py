"""Model factories: the flagship and ART-V configurations, and models,
tokenizers and datasets made from CLI args.

Counterpart of ``__graft_entry__._flagship`` and of ``get_tokenizer`` /
``get_vae_model`` / ``get_dalle`` / ``get_dataset`` in
``mmvid_tpu/factories.py`` (mask-predict models with the cvae of the
visual-control recipes, and ART-V with ``--ar``), the fixed language
model (:func:`get_fixed_language_model`), the drivers' build
(:func:`get_driver_model`: JAX's ``get_dalle`` dtypes, weights from a
seed, the pretrained CLIP stack grafted from ``--openai_clip_model_path``
where the archive exists, and taming VQGAN checkpoints), and the
training builds of the
flagship and ART-V (:func:`flagship_train`, :func:`artv_train`: fp32
parameters, the compute dtype at use, each block rematerialised, as
``scripts/bench_train.py`` builds JAX's).  Every factory puts the model
on ``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import warnings

import numpy as np
import torch
from torch import nn

from mmvid_tpu_torch.models.artv import ArtvConfig, ArtvModel
from mmvid_tpu_torch.models.axial import AxialPositionalEmbedding
from mmvid_tpu_torch.models.bert import BertConfig
from mmvid_tpu_torch.models.clip import (
    ClipStackConfig,
    load_openai_clip_stack,
)
from mmvid_tpu_torch.models.mmvid import MMVIDBert
from mmvid_tpu_torch.models.vqgan import VQGanConfig, VQGanVAE
from mmvid_tpu_torch.tokenizer import SimpleTokenizer
from mmvid_tpu_torch.weights import load_weights


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter from ``generator`` (a CPU generator), in
    ``named_modules`` order: embeddings N(0, 1), the VQGAN codebook
    U(-1/n, 1/n), norms ones/zeros, biases zeros, other weights
    N(0, 1/fan_in)."""
    for name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                val = (torch.ones if pname == 'weight' else torch.zeros)(
                    p.shape)
            elif 'bias' in pname:
                val = torch.zeros(p.shape)
            elif name.endswith('quantize.embedding'):
                n = p.shape[0]
                val = (torch.rand(p.shape, generator=generator) * 2 - 1) / n
            elif isinstance(mod, (nn.Embedding, AxialPositionalEmbedding)):
                val = torch.randn(p.shape, generator=generator)
            else:
                fan_in = p[0].numel()
                val = (torch.randn(p.shape, generator=generator)
                       * fan_in ** -0.5)
            p.copy_(val)


def flagship(tiny: bool = False, dtype=torch.float32, device='cuda',
             seed: int = 0, use_cvae: bool = False, param_dtype=None,
             remat: bool = False):
    """Flagship text-to-video model (scripts/mmvoxceleb/text_to_video):
    768 x 12-layer backbone, 8 frames at 128 px -> 8x8 tokens each,
    text_seq_len 50; ``tiny`` is the JAX package's CPU test size.
    ``use_cvae`` adds one visual control frame tokenized by a cvae of the
    same VQGAN architecture (the text+mask recipe's layout).  Weights are
    drawn from ``torch.Generator().manual_seed(seed)``; ``param_dtype``
    (``dtype`` unless given) is the backbone's and heads' parameters'
    dtype; ``remat`` checkpoints each backbone block under grad
    (``ClipStackConfig.remat``).  Returns (model, vae)."""
    if tiny:
        vq_cfg = VQGanConfig(resolution=16, ch=32, ch_mult=(1, 2),
                             num_res_blocks=1, z_channels=64, embed_dim=64,
                             n_embed=1024, attn_resolutions=())
        image_size = 16
        cfg = BertConfig(dim=64, num_text_tokens=100, text_seq_len=8,
                         num_visuals=0, num_targets=2, num_image_tokens=1024,
                         image_fmap_size=8, image_size=16,
                         clip=ClipStackConfig(width=64, layers=2, heads=2,
                                              remat=remat))
    else:
        vq_cfg, image_size = VQGanConfig(), 128
        cfg = BertConfig(dim=768, num_text_tokens=49408, text_seq_len=50,
                         num_visuals=0, num_targets=8, num_image_tokens=1024,
                         image_fmap_size=8, image_size=128,
                         clip=ClipStackConfig(width=768, layers=12,
                                              heads=12, remat=remat))
    vae = VQGanVAE(image_size=image_size, cfg=vq_cfg, dtype=dtype)
    cvae = None
    if use_cvae:
        cfg = dataclasses.replace(cfg, num_visuals=1)
        cvae = VQGanVAE(image_size=image_size, cfg=vq_cfg, dtype=dtype)
    model = MMVIDBert(cfg, vae, cvae=cvae, dtype=dtype,
                      param_dtype=param_dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval(), model.vae


def artv_tiny(dtype=torch.float32, device='cuda', seed: int = 0,
              use_cvae: bool = False, param_dtype=None):
    """ART-V, the autoregressive baseline, at the JAX package's CPU test
    size (tests/test_artv.py: dim 64, 2 layers, 2 heads, 6 text positions
    of 50 tokens, one visual position block, 2 frames at 32 px).  The
    full-width model is ``get_dalle(artv_args(), vae)``.  ``use_cvae``
    adds a cvae for visual control frames.  Weights from
    ``torch.Generator().manual_seed(seed)``.  Returns (model, vae)."""
    vq_cfg = VQGanConfig(resolution=32, ch=32, ch_mult=(1, 2, 2),
                         num_res_blocks=1, z_channels=64, embed_dim=64,
                         n_embed=1024, attn_resolutions=())
    cfg = ArtvConfig(dim=64, num_text_tokens=50, text_seq_len=6,
                     num_visuals=1, num_targets=2, num_image_tokens=1024,
                     image_fmap_size=8, image_size=32,
                     clip=ClipStackConfig(width=64, layers=2, heads=2))
    vae = VQGanVAE(image_size=32, cfg=vq_cfg, dtype=dtype)
    cvae = (VQGanVAE(image_size=32, cfg=vq_cfg, dtype=dtype)
            if use_cvae else None)
    model = ArtvModel(cfg, vae, cvae=cvae, dtype=dtype,
                      param_dtype=param_dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval(), model.vae


def flagship_train(tiny: bool = False, dtype=torch.bfloat16,
                   device='cuda', seed: int = 0, remat: bool = True):
    """The flagship's training build: :func:`flagship`'s model with fp32
    parameters, computing in ``dtype`` (the weights cast at use), each
    block rematerialised with ``remat``; weights from ``seed`` (the same
    values as the serving build's before its rounding).  Returns (model,
    vae); train ``model.core``'s parameters, the VQGAN stays frozen."""
    return flagship(tiny=tiny, dtype=dtype, device=device, seed=seed,
                    param_dtype=torch.float32, remat=remat)


def artv_train(tiny: bool = False, dtype=torch.bfloat16, device='cuda',
               seed: int = 0):
    """ART-V's training build: fp32 parameters computing in ``dtype``, no
    remat (as JAX trains it); the full-width model of :func:`artv_args`
    (the text-to-video flags with ``--ar``), or with ``tiny``
    :func:`artv_tiny`'s.  Weights from ``seed``.  Returns (model, vae)."""
    if tiny:
        return artv_tiny(dtype=dtype, device=device, seed=seed,
                         param_dtype=torch.float32)
    args = artv_args()
    vae = get_vae_model(args, dtype=dtype, device=device)
    model = get_dalle(args, vae, dtype=dtype, device=device,
                      param_dtype=torch.float32).eval()
    init_weights(model, torch.Generator().manual_seed(seed))
    return model, vae


def build_clip_config(which_transformer: str) -> ClipStackConfig:
    if which_transformer == 'openai_clip_visual':
        return ClipStackConfig(width=768, layers=12, heads=12)
    if which_transformer == 'openai_clip_text':
        return ClipStackConfig(width=512, layers=12, heads=8)
    if which_transformer.startswith('custom:'):
        # 'custom:<width>:<layers>:<heads>'
        _, w, l, h = which_transformer.split(':')
        return ClipStackConfig(width=int(w), layers=int(l), heads=int(h))
    raise NotImplementedError(which_transformer)


def text_and_mask_args():
    """The model flags of the released text+mask recipe
    (scripts/mmvoxceleb/text_and_mask/test.sh) as ``test.py`` reads them:
    the openai_clip_visual backbone, 50 text tokens, one control frame
    tokenized by a cvae, 8 targets at 128 px, vc_mode mask_8x8, 20
    mask-predict rounds, batch 16."""
    return argparse.Namespace(
        which_transformer='openai_clip_visual', dim=768, text_seq_len=50,
        num_visuals=1, num_targets=8, image_size=128, use_cvae=True,
        vc_mode='mask_8x8', mp_T=20, batch_size=16, which_vae='vqgan1024',
        insert_sep=False, use_separate_visual_emb=False,
        fixed_language_model=None, text_emb_bottleneck=None)


def artv_args():
    """The text-to-video recipe's model flags with ``--ar``
    (scripts/mmvoxceleb/text_to_video, as ``mmvid_tpu/factories.py``
    builds ART-V from them and ``scripts/bench_artv.py`` measures it): the
    openai_clip_visual backbone, 50 text tokens, 8 targets at 128 px,
    batch 16; ``get_dalle`` raises num_visuals to 1."""
    return argparse.Namespace(
        which_transformer='openai_clip_visual', dim=768, text_seq_len=50,
        num_visuals=0, num_targets=8, image_size=128, use_cvae=False,
        batch_size=16, which_vae='vqgan1024', ar=True, loss_img_weight=7,
        insert_sep=False, use_separate_visual_emb=False,
        fixed_language_model=None, text_emb_bottleneck=None)


def get_vae_model(args, dtype=torch.float32, device='cuda') -> VQGanVAE:
    """The vqgan1024 tokenizer at ``args.image_size``: the targets' vae
    and, for the visual-control recipes, the cvae are each one call (the
    same architecture); weights left to the caller."""
    kind = getattr(args, 'which_vae', 'vqgan1024')
    if kind != 'vqgan1024':
        raise NotImplementedError(f'which_vae={kind!r}; only vqgan1024')
    image_size = args.image_size or 256
    return VQGanVAE(image_size=image_size,
                    cfg=VQGanConfig(resolution=image_size),
                    dtype=dtype).to(device)


def get_dalle(args, vae: VQGanVAE, cvae: VQGanVAE | None = None,
              dtype=torch.float32, device='cuda',
              param_dtype=None, clip_cfg=None,
              text_feature_dim: int = 0) -> MMVIDBert | ArtvModel:
    """MMVIDBert from CLI args, or ArtvModel with ``args.ar``, with
    ``cvae`` tokenizing the visual controls when given (weights left to
    the caller; ``param_dtype``: the dense parameters', ``dtype``
    unless given; ``clip_cfg``: the backbone's, ``--which_transformer``'s
    unless given).  With ``--fixed_language_model`` the text is one token
    of ``text_feature_dim`` features (:func:`get_fixed_language_model`'s
    width); ART-V takes no fixed language model."""
    clip_cfg = clip_cfg or build_clip_config(args.which_transformer)
    if args.dim != clip_cfg.width:
        raise ValueError(f'--dim {args.dim} must match the '
                         f'{args.which_transformer} width {clip_cfg.width}')
    fixed_lm = getattr(args, 'fixed_language_model', None)
    if getattr(args, 'ar', False):
        if fixed_lm is not None:
            raise ValueError('--ar with --fixed_language_model: ART-V '
                             'takes text ids, no fixed language model')
        cfg = ArtvConfig(
            dim=args.dim, num_text_tokens=49408,
            text_seq_len=args.text_seq_len,
            num_visuals=max(args.num_visuals, 1),
            num_targets=args.num_targets, num_image_tokens=vae.num_tokens,
            image_fmap_size=vae.fmap_size, image_size=vae.image_size,
            loss_img_weight=getattr(args, 'loss_img_weight', 7),
            clip=clip_cfg)
        return ArtvModel(cfg, vae, cvae=cvae, dtype=dtype,
                         param_dtype=param_dtype).to(device)
    cfg = BertConfig(
        dim=args.dim, num_text_tokens=49408,
        text_seq_len=args.text_seq_len if fixed_lm is None else 1,
        num_visuals=args.num_visuals, num_targets=args.num_targets,
        num_image_tokens=vae.num_tokens, image_fmap_size=vae.fmap_size,
        image_size=vae.image_size, insert_sep=args.insert_sep,
        use_separate_visual_emb=args.use_separate_visual_emb,
        fixed_language_model=fixed_lm, text_feature_dim=text_feature_dim,
        text_emb_bottleneck=args.text_emb_bottleneck, clip=clip_cfg)
    return MMVIDBert(cfg, vae, cvae=cvae, dtype=dtype,
                     param_dtype=param_dtype).to(device)


def get_tokenizer(args):
    """reference utils_train.py:185-191 ('simple' | 'hug')."""
    which = getattr(args, 'which_tokenizer', 'simple')
    if which == 'simple':
        return SimpleTokenizer(args.bpe_path) if args.bpe_path \
            else SimpleTokenizer()
    if which == 'hug':
        from transformers import AutoTokenizer
        hf = AutoTokenizer.from_pretrained(args.bpe_path)

        class HugWrap:
            vocab_size = hf.vocab_size

            def tokenize(self, texts, context_length, truncate_text=False):
                if isinstance(texts, str):
                    texts = [texts]
                enc = hf(texts, padding='max_length', truncation=True,
                         max_length=context_length)
                return np.asarray(enc['input_ids'], np.int32)

        return HugWrap()
    raise NotImplementedError(which)


def get_fixed_language_model(args, device='cuda'):
    """(encode, hidden_size) of ``--fixed_language_model roberta-large``,
    as ``mmvid_tpu/factories.py::get_fixed_language_model`` returns them:
    ``encode(texts)`` gives the captions' mean-pooled RoBERTa features
    [B, hidden_size] fp32 on ``device``
    (:class:`~mmvid_tpu_torch.models.roberta.RobertaModel`).  The model
    folder is ``ROBERTA_PATH`` (default ``roberta-large``, as JAX's): its
    ``config.json``, ``vocab.json`` + ``merges.txt`` (or
    ``tokenizer.json``), and ``model.safetensors`` or
    ``pytorch_model.bin``.  Nothing is downloaded."""
    from mmvid_tpu_torch.models.roberta import RobertaModel
    if args.fixed_language_model != 'roberta-large':
        raise ValueError(f'--fixed_language_model '
                         f'{args.fixed_language_model!r}: only '
                         "'roberta-large'")
    path = os.environ.get('ROBERTA_PATH', 'roberta-large')
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f'ROBERTA_PATH={path!r} is not a folder: set ROBERTA_PATH to a '
            'local roberta-large folder (config.json, vocab.json, '
            'merges.txt, model.safetensors or pytorch_model.bin)')
    model = RobertaModel.from_pretrained(path, device=device)
    return model.encode, model.cfg.hidden_size


def load_pretrained_stack(args):
    """(the backbone's ClipStackConfig, the pretrained resblocks'
    state_dict or None), as ``mmvid_tpu/factories.py::
    load_pretrained_stack`` resolves them: an openai_clip_* backbone takes
    the width, layers and heads of ``--openai_clip_model_path``'s stack
    where that torch.jit archive exists (the reference always finetunes
    it, clip_model.py:535-543); without the archive, a loud warning and
    the flag's config, randomly initialized."""
    clip_cfg = build_clip_config(args.which_transformer)
    if not args.which_transformer.startswith('openai_clip'):
        return clip_cfg, None
    path = getattr(args, 'openai_clip_model_path', None)
    if path and os.path.exists(path):
        return load_openai_clip_stack(path, args.which_transformer)
    warnings.warn(
        f'openai_clip_model_path {path!r} not found: the '
        f'{args.which_transformer} backbone will be RANDOMLY initialized. '
        'The reference recipe finetunes the pretrained CLIP stack '
        '(clip_model.py:535-543); results will not be comparable without '
        'ViT-B-32.pt.', stacklevel=2)
    return clip_cfg, None


def graft_transformer_params(model, stack_sd) -> None:
    """Load the pretrained resblocks ``stack_sd`` into ``model``'s
    backbone (``transformer.transformer``), each key and shape checked,
    cast to the parameters' dtype."""
    stack = model.transformer['transformer']
    fresh = stack.state_dict()
    missing = sorted(set(fresh) - set(stack_sd))
    extra = sorted(set(stack_sd) - set(fresh))
    if missing or extra:
        raise KeyError(f'pretrained stack keys mismatch: missing={missing} '
                       f'extra={extra}')
    for k, v in stack_sd.items():
        if tuple(v.shape) != tuple(fresh[k].shape):
            raise ValueError(f'{k}: shape {tuple(v.shape)} != expected '
                             f'{tuple(fresh[k].shape)}')
    stack.load_state_dict(stack_sd)


def taming_vqgan_state(path: str) -> dict:
    """A taming-transformers VQGAN ``.ckpt``'s VQModel weights: its
    ``state_dict`` without the loss and colorize entries."""
    sd = torch.load(path, map_location='cpu', weights_only=False)
    return {k: v for k, v in sd['state_dict'].items()
            if not k.startswith(('loss.', 'colorize'))}


def get_driver_model(args, device='cuda', use_cvae=None,
                     training: bool = True, text_feature_dim: int = 0):
    """The drivers' model from CLI args, as ``mmvid_tpu/factories.py::
    get_dalle`` builds it: with ``--bf16`` (or ``--fp16``) fp32 parameters
    computing in bf16 (a serving build, ``training`` False, keeps its
    weights in bf16, as ``generate.load_model`` does), else fp32
    throughout; no remat.  Every weight is drawn by :func:`init_weights`
    from ``--seed``; then an openai_clip_* backbone takes the pretrained
    resblocks of ``--openai_clip_model_path`` where that archive exists
    (:func:`load_pretrained_stack`), and ``--vae_path`` / ``--cvae_path``
    load taming VQGAN checkpoints.  ``use_cvae`` (default: a
    ``--cvae_path`` is given) adds the visual-control VQGAN.  The VQGANs
    compute, and keep their weights, in the compute dtype.
    ``text_feature_dim``: the fixed language model's width, with
    ``--fixed_language_model``.  Returns the model, on ``device``."""
    clip_cfg, stack_sd = load_pretrained_stack(args)
    bf16 = getattr(args, 'bf16', False) or getattr(args, 'fp16', False)
    dtype = torch.bfloat16 if bf16 else torch.float32
    if use_cvae is None:
        use_cvae = bool(getattr(args, 'cvae_path', None))
    vae = get_vae_model(args, dtype=dtype, device=device)
    cvae = get_vae_model(args, dtype=dtype, device=device) if use_cvae \
        else None
    model = get_dalle(args, vae, cvae, dtype=dtype, device=device,
                      param_dtype=torch.float32 if training else dtype,
                      clip_cfg=clip_cfg, text_feature_dim=text_feature_dim)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    if stack_sd is not None:
        graft_transformer_params(model, stack_sd)
    if getattr(args, 'vae_path', None):
        load_weights(vae.model, taming_vqgan_state(args.vae_path))
    if cvae is not None and getattr(args, 'cvae_path', None):
        load_weights(cvae.model, taming_vqgan_state(args.cvae_path))
    return model


def get_dataset(args, tokenizer):
    """reference utils_train.py get_dataset: route by args.dataset, as
    ``mmvid_tpu/factories.py`` routes it."""
    from mmvid_tpu_torch.data import (
        TextImageDataset,
        TextImageStackDataset,
        TextVideoDataset,
        VoxDataset,
    )
    keys = None
    if args.dataset_keys:
        with open(args.dataset_keys) as f:
            keys = [line.strip() for line in f if line.strip()]
    common = dict(
        text_len=args.text_seq_len, image_size=args.image_size or 128,
        truncate_captions=args.truncate_captions,
        resize_ratio=args.resize_ratio, tokenizer=tokenizer,
        cache=args.dataset_cache, deterministic=args.deterministic,
        frame_step=args.frame_step, frame_num=args.frame_num, keys=keys,
        video_only=args.video_only)
    if args.dataset == 'video_text':
        return TextVideoDataset(args.image_text_folder,
                                return_neg=args.negvc,
                                drop_sentence=args.drop_sentence, **common)
    if args.dataset == 'imagestack_text':
        # reference utils_train.py:64-80: TextImageStackDataset in video
        # mode with return_vc=True (first frame as the visual control)
        return TextImageStackDataset(
            args.image_text_folder, text_len=args.text_seq_len,
            image_size=args.image_size or 128,
            truncate_captions=args.truncate_captions,
            resize_ratio=args.resize_ratio, tokenizer=tokenizer,
            deterministic=args.deterministic, frame_step=args.frame_step,
            frame_num=args.frame_num, keys=keys,
            video_only=args.video_only, cache=args.dataset_cache)
    if args.dataset == 'image_text':
        return TextImageDataset(
            args.image_text_folder, text_len=args.text_seq_len,
            image_size=args.image_size or 128,
            truncate_captions=args.truncate_captions,
            resize_ratio=args.resize_ratio, tokenizer=tokenizer,
            cache=args.dataset_cache, deterministic=args.deterministic)
    if args.dataset in ('vox', 'mmvoxceleb'):
        return VoxDataset(args.image_text_folder, attr_mode=args.attr_mode,
                          return_neg=args.negvc, **common)
    if args.dataset == 'iper':
        from mmvid_tpu_torch.data.iper import IPERDataset
        return IPERDataset(args.image_text_folder, slow=args.slow, **common)
    if args.dataset == 'shape':
        return TextVideoDataset(args.image_text_folder, **common)
    if args.dataset == 'shape_attr':
        from mmvid_tpu_torch.data.shapes import ShapeAttrDataset
        return ShapeAttrDataset(args.image_text_folder,
                                attr_mode=args.attr_mode,
                                return_neg=args.negvc, **common)
    if args.dataset == 'mp4_text':
        raise NotImplementedError(
            '--dataset mp4_text is not ported yet: TextMP4Dataset decodes '
            'MP4 through OpenCV (cv2), which the port does not use '
            '(ROADMAP.md queue A, item A4)')
    raise NotImplementedError(args.dataset)
