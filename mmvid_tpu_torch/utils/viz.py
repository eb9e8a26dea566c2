"""Sample visualization (reference utils/utils_train.py:391-1217).

The port's copy of ``render_visual_prompt`` and ``visualize_train`` from
``mmvid_tpu/utils/viz.py``: per-sample grids (real / reconstruction / N
generated variants / counterfactual-control samples) as PNGs + a caption
txt, and optional HTML rows.  Where JAX splits a key before each sampling
call, the port passes one ``torch.Generator`` through the calls in the
same order.  ``save_pnag_debug_grid`` (``--debug``), ``test_mode='shapes'``
and the long / interp / interp_real modes are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from mmvid_tpu_torch.utils.html import (
    HTML,
    save_image_array,
    tile_grid,
    tile_video_row,
)


def _cap_file(path: str, lines):
    with open(path, 'w') as f:
        f.write('\n'.join(lines))


def render_visual_prompt(visual: np.ndarray, vc_mode=None,
                         rand_visual: bool = False, rng=None):
    """Occlude the displayed visual control to match what the model actually
    sees under vc_mode / rand_visual (reference utils_train.py:456-520).

    visual: [B, V, H, W, 3] in [0,1].  Returns (overlay, face_mode) — the
    face_mode chosen here must be passed to generate_images so the token
    corruption matches the rendered occlusion."""
    import random as _random
    r = (rng.random if rng is not None else _random.random)
    vp = np.array(visual, copy=True)
    face_mode = None
    H = vp.shape[2]
    bs = H // 8
    if rand_visual:
        vp[:, :, H // 2:, :, :] = 1.0
    if vc_mode == 'face_8x8':
        out = np.ones_like(vp)
        if r() < 0.5:
            face_mode = 'eyes_nose'
            out[:, :, 2 * bs:5 * bs, 1 * bs:7 * bs] = \
                vp[:, :, 2 * bs:5 * bs, 1 * bs:7 * bs]
        else:
            face_mode = 'mouth'
            out[:, :, 5 * bs:7 * bs, 2 * bs:6 * bs] = \
                vp[:, :, 5 * bs:7 * bs, 2 * bs:6 * bs]
        vp = out
    elif vc_mode == 'face2_8x8':
        out = np.ones_like(vp)
        out[:, 0] = vp[:, 0]
        out[:, 1:, 2 * bs:6 * bs, 2 * bs:6 * bs] = \
            vp[:, 1:, 2 * bs:6 * bs, 2 * bs:6 * bs]
        face_mode = 'face2'
        vp = out
    elif vc_mode in ('mask_8x8', 'mask2_8x8'):
        out = np.ones_like(vp)
        out[:, :, 1 * bs:7 * bs, 1 * bs:7 * bs] = \
            vp[:, :, 1 * bs:7 * bs, 1 * bs:7 * bs]
        face_mode = 'mask2' if vc_mode == 'mask2_8x8' else 'mask'
        vp = out
    elif vc_mode == 'shape_4x4':
        b4 = H // 4
        vp[:, :, 1 * b4:3 * b4, 1 * b4:3 * b4] = 1.0
        face_mode = 'shape'
    return vp, face_mode


def _host(x) -> np.ndarray:
    return x.float().cpu().numpy()


@torch.no_grad()
def visualize_train(model, batch: Dict, generator: torch.Generator,
                    out_dir: str, iteration: int, *,
                    n_sample: Optional[int] = None, n_per_sample: int = 2,
                    mask_predict_steps=0, mask_predict_steps1: int = 0,
                    vc_mode=None, rand_visual: bool = False,
                    counterfactual: bool = False, debug: bool = False,
                    test_mode: Optional[str] = None,
                    webpage: Optional[HTML] = None, mp_config=None):
    """Real / recon / generated (/counterfactual-control) grids
    (reference visualize_train/visualize_test, utils_train.py:391-1217).

    ``batch`` holds numpy arrays (the loader's); its ``text`` may also be
    a tensor, and for a fixed-LM model is the captions' features;
    ``generator`` is a
    torch.Generator on the model's device.  mask_predict_steps may be an
    int or a list — like the reference's --mask_predict_steps 10 20 30,
    each generated row cycles through the list.  counterfactual=True adds
    a row conditioned on the NEIGHBOUR sample's visual control (batch
    roll) sampled with mask_predict_steps1, and a row with no control.
    With a visual control the grid rows lead with the control frames,
    occluded per vc_mode/rand_visual so the viewer sees what the model saw
    (render_visual_prompt, reference utils_train.py:456-520); the chosen
    face_mode drives the matching token corruption.  ``debug`` and
    ``test_mode='shapes'`` raise NotImplementedError (ROADMAP.md)."""
    if debug:
        raise NotImplementedError('--debug step grids '
                                  '(save_pnag_debug_grid) are not ported '
                                  'yet: ROADMAP.md queue A')
    if test_mode == 'shapes':
        raise NotImplementedError("test_mode='shapes' is not ported yet: "
                                  'ROADMAP.md queue A')
    os.makedirs(out_dir, exist_ok=True)
    dev = next(model.parameters()).device
    text = torch.as_tensor(batch['text'], device=dev)
    text = text if text.is_floating_point() else text.long()
    target = torch.as_tensor(np.asarray(batch['target']),
                             dtype=torch.float32, device=dev)
    visual = (torch.as_tensor(np.asarray(batch['visual']),
                              dtype=torch.float32, device=dev)
              if batch.get('visual') is not None
              and model.cfg.num_visuals > 0 else None)
    if n_sample is not None:
        # N_SAMPLE = min(n_sample, batch) (reference utils_train.py:406)
        n = min(n_sample, text.shape[0])
        text, target = text[:n], target[:n]
        visual = visual[:n] if visual is not None else None
        batch = dict(batch)
        if 'description' in batch:
            batch['description'] = list(batch['description'])[:n]

    steps_list = (list(mask_predict_steps)
                  if isinstance(mask_predict_steps, (list, tuple))
                  else [mask_predict_steps])

    rows = []          # each: (gen_videos [B,T,H,W,3], prompt or None)
    captions = batch.get('description', [''] * text.shape[0])

    recon = _host(model.recon_images(target))
    prompt = visual_recon = None
    face_mode = None
    if visual is not None:
        visual_recon = _host(model.recon_images(visual, which_vae='cvae'))
        prompt, face_mode = render_visual_prompt(
            _host(visual), vc_mode=vc_mode, rand_visual=rand_visual)
    for j in range(n_per_sample):
        videos, _ = model.generate_images(
            generator, text, visual=visual, erase_visual=rand_visual,
            vc_mode=vc_mode, face_mode=face_mode,
            mask_predict_steps=steps_list[j % len(steps_list)],
            dynamic=True, mp_config=mp_config)
        rows.append((_host(videos), prompt))

    if counterfactual and visual is not None:
        # counterfactual: the NEIGHBOUR sample's control
        cf_visual = torch.roll(visual, 1, dims=0)
        cf_prompt, cf_face = render_visual_prompt(
            _host(cf_visual), vc_mode=vc_mode, rand_visual=rand_visual)
        videos, _ = model.generate_images(
            generator, text, visual=cf_visual, vc_mode=vc_mode,
            face_mode=cf_face, mask_predict_steps=mask_predict_steps1,
            dynamic=True, mp_config=mp_config)
        rows.append((_host(videos), cf_prompt))
        # free-form: no visual control at all (fully-masked visual row,
        # reference visualize_test's "free" samples)
        videos, _ = model.generate_images(
            generator, text, visual=None,
            mask_predict_steps=mask_predict_steps1, dynamic=True,
            mp_config=mp_config)
        rows.append((_host(videos), None))

    def _row(i, frames, vis):
        if vis is None:
            return tile_video_row(frames)
        return tile_video_row(np.concatenate([vis[i], frames], axis=0))

    target_h = _host(target)
    visual_h = _host(visual) if visual is not None else None
    for i in range(text.shape[0]):
        grid_rows = [_row(i, target_h[i], visual_h),
                     _row(i, recon[i], visual_recon)]
        for videos, vis in rows:
            grid_rows.append(_row(i, videos[i], vis))
        save_image_array(
            os.path.join(out_dir, f'{iteration:07d}_{i}.png'),
            tile_grid(grid_rows))
        if webpage is not None:
            name = webpage.save_media(f'{iteration:07d}_{i}.gif',
                                      rows[0][0][i])
            webpage.add_media_row([(name, captions[i])])
    _cap_file(os.path.join(out_dir, f'{iteration:07d}_captions.txt'),
              list(captions))
    if webpage is not None:
        webpage.add_header(f'iteration {iteration}')
        webpage.save()
