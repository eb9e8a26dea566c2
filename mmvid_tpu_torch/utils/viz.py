"""Sample visualization (reference utils/utils_train.py:391-1654).

The port's copy of ``mmvid_tpu/utils/viz.py``: per-sample grids (real /
reconstruction / N generated variants / counterfactual-control samples)
as PNGs + a caption txt, and optional HTML rows; the PNAG debug grids
(``debug``), the shapes recipe's per-slot rows (``test_mode='shapes'``);
and the three long-video modes:

* ``long``   - sliding-window extrapolation preserving the last t_overlap
  frames' tokens per chunk (utils_train.py:1337-1373)
* ``interp`` - hierarchical binary interpolation, alternate frames
  preserved, doubling length per level (utils_train.py:1374-1431)
* ``interp_real`` - interpolate a real video's tokens (:1433-1527)

Where JAX splits a key before each sampling call, the port passes one
``torch.Generator`` through the calls in the same order.  The VQGAN
decodes and encodes the long videos ``FRAME_CHUNK`` frames a call: each
frame is independent, so the frames are those of one call, and one call
over thousands of frames does not fit on the card.
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


# frames a VQGAN call takes in the long modes: one batch of 16
# eight-frame clips
FRAME_CHUNK = 128


def decode_frames(model, ids) -> np.ndarray:
    """ids [F, n] -> frames [F, H, W, 3] in [0, 1] on the host."""
    return np.concatenate([_host(model.vae.decode(c))
                           for c in ids.split(FRAME_CHUNK)])


def video_tokens(model, video) -> torch.Tensor:
    """``model.get_image_tokens`` of video [B, F, H, W, 3] in [0, 1] (host
    or device) -> ids [B, F*n] on the model's device."""
    dev = next(model.parameters()).device
    video = torch.as_tensor(np.asarray(video), dtype=torch.float32)
    b = video.shape[0]
    flat = video.reshape((-1,) + video.shape[2:])
    toks = torch.cat([model.get_image_tokens(c.to(dev))
                      for c in flat.split(FRAME_CHUNK)])
    return toks.reshape(b, -1)


def save_pnag_debug_grid(model, path: str, real_frames: np.ndarray,
                         step_decodes: np.ndarray, step_keeps: np.ndarray):
    """The reference's debug grid (utils_train.py:578-590 +
    dalle_bert.py:694-700): row 0 = real frames, then per refinement step a
    'masked input' row (previous decode blended with the re-mask overlay at
    0.7/0.4) and the step's decode row.  real_frames/step_decodes in [0,1];
    step_keeps [S, T*n] bool for ONE sample."""
    cfg = model.cfg
    n = cfg.image_fmap_size
    scale = cfg.image_size // n
    rows = [tile_video_row(real_frames), tile_video_row(step_decodes[0])]
    for s in range(1, step_decodes.shape[0]):
        remask = (~step_keeps[s]).reshape(cfg.num_targets, n, n)
        overlay = np.kron(remask.astype(np.float32),
                          np.ones((scale, scale), np.float32))[..., None]
        masked_img = np.clip(step_decodes[s - 1] * 0.7 + overlay * 0.4,
                             0, 1)
        rows.append(tile_video_row(masked_img))
        rows.append(tile_video_row(step_decodes[s]))
    save_image_array(path, tile_grid(rows))


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
    face_mode drives the matching token corruption.  debug=True
    additionally writes per-step PNAG grids to <out_dir>/<iter>_pnag/
    (reference --debug, utils_train.py:578-590).

    test_mode='shapes' (the shapes evaluation recipe, reference
    utils_train.py:1160-1196, gated at :1030): for each of the 3 visual
    control slots, swap ONLY that slot with the loader-provided negative
    (batch['visual_neg']) and render a per-slot counterfactual row
    sampled at mask_predict_steps1."""
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
    target_h = _host(target)
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

    if debug:
        pnag_dir = os.path.join(out_dir, f'{iteration:07d}_pnag')
        os.makedirs(pnag_dir, exist_ok=True)
        _, _, step_decodes, step_keeps = model.generate_images_debug(
            generator, text, visual=visual, erase_visual=rand_visual,
            vc_mode=vc_mode, face_mode=face_mode,
            mask_predict_steps=steps_list[0], mp_config=mp_config)
        for i in range(text.shape[0]):
            save_pnag_debug_grid(
                model, os.path.join(pnag_dir, f'{i:02d}.png'), target_h[i],
                _host(step_decodes[:, i]), step_keeps[:, i].cpu().numpy())

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

    if (test_mode == 'shapes' and visual is not None
            and batch.get('visual_neg') is not None):
        # reference utils_train.py:1160-1196: swap each of the 3 control
        # slots with its loader-provided negative, one row per slot
        visual_neg = torch.as_tensor(np.asarray(batch['visual_neg']),
                                     dtype=torch.float32,
                                     device=dev)[:visual.shape[0]]
        for kk in range(min(3, visual.shape[1])):
            cf_visual = visual.clone()
            cf_visual[:, kk] = visual_neg[:, kk]
            cf_prompt, cf_face = render_visual_prompt(
                _host(cf_visual), vc_mode=vc_mode, rand_visual=rand_visual)
            videos, _ = model.generate_images(
                generator, text, visual=cf_visual, vc_mode=vc_mode,
                face_mode=cf_face, erase_visual=rand_visual,
                mask_predict_steps=mask_predict_steps1, dynamic=True,
                mp_config=mp_config)
            rows.append((_host(videos), cf_prompt))

    def _row(i, frames, vis):
        if vis is None:
            return tile_video_row(frames)
        return tile_video_row(np.concatenate([vis[i], frames], axis=0))

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


def generate_long_video(model, generator, text, visual=None, *,
                        t_repeat: int = 10, t_overlap: int = 1,
                        mask_predict_steps: int = 0, mp_config=None):
    """Sliding-window extrapolation (utils_train.py:1337-1373): each chunk
    preserves the previous chunk's last t_overlap frames' tokens and appends
    the novel tail.  Returns [B, T + (t_repeat-1)(T-t_overlap), H, W, 3]
    on the host."""
    videos, seq = model.generate_images(
        generator, text, visual=visual,
        mask_predict_steps=mask_predict_steps, dynamic=False,
        mp_config=mp_config)
    chunks = [_host(videos)]
    for _ in range(1, t_repeat):
        videos, seq = model.generate_images(
            generator, text, visual=visual,
            mask_predict_steps=mask_predict_steps, dynamic=False,
            preserve=seq, t_overlap=t_overlap, long_mode='long',
            mp_config=mp_config)
        chunks.append(_host(videos)[:, t_overlap:])
    return np.concatenate(chunks, axis=1)


def generate_interpolated_video(model, generator, text, visual=None, *,
                                levels: int = 1, mask_predict_steps: int = 0,
                                mp_config=None):
    """Hierarchical binary interpolation (utils_train.py:1374-1431):
    each level doubles temporal density — the source frames are preserved
    at the even slots of a num_targets-frame window and the odd slots are
    re-sampled.  Returns [B, T * 2^levels, H, W, 3] on the host."""
    cfg = model.cfg
    t = cfg.num_targets
    n_tok = cfg.image_seq_len
    b = text.shape[0]
    _, seq = model.generate_images(
        generator, text, visual=visual,
        mask_predict_steps=mask_predict_steps, dynamic=False,
        mp_config=mp_config, decode=False)

    for _ in range(levels):
        s = seq.shape[1] // n_tok           # current frame count
        if s % (t // 2):
            raise ValueError(f'interp needs a frame count ({s}) divisible '
                             f'by num_targets/2 ({t // 2})')
        grid = seq.reshape(b, s, n_tok)
        windows = []
        for w in range(s // (t // 2)):
            src = grid[:, w * (t // 2):(w + 1) * (t // 2)]
            # the preserve layout reads the FIRST T/2 frames of the buffer
            # and pins them at even slots (sampler.arrange_preserve_tokens)
            src_full = torch.cat([src, torch.zeros_like(src)],
                                 dim=1).reshape(b, -1)
            _, out = model.generate_images(
                generator, text, visual=visual,
                mask_predict_steps=mask_predict_steps, dynamic=False,
                preserve=src_full, long_mode='interp',
                mp_config=mp_config, decode=False)
            windows.append(out)
        seq = torch.cat(windows, dim=1)

    total = seq.shape[1] // n_tok
    frames = decode_frames(model, seq.reshape(b * total, n_tok))
    return frames.reshape((b, total) + frames.shape[1:])


def generate_interp_real_video(model, generator, text, source_tokens,
                               visual=None, *, t_repeat: int = 2,
                               mask_predict_steps: int = 0, mp_config=None):
    """Interpolate a REAL video's tokens (utils_train.py:1433-1527).

    Unlike plain interp's disjoint windows, interp_real slides a window of
    T/2 source frames with stride T/4 (overlapping), generates T frames per
    window (sources preserved at even slots), keeps the first T/2 output
    frames per window (the last window keeps T-1), and repeats per level.
    Level t length: last_tt*T/2 + T - 1 where
    last_tt = (curr_len - T/2) // (T/4).  Returns [B, final_len, H, W, 3]
    on the host.
    """
    cfg = model.cfg
    t_full = cfg.num_targets
    n_tok = cfg.image_seq_len
    if t_full % 4:
        raise ValueError('interp_real needs num_targets divisible by 4, '
                         f'not {t_full}')
    b = text.shape[0]
    grid = source_tokens.reshape(b, -1, n_tok)

    for _level in range(1, t_repeat):
        curr_len = grid.shape[1]
        if curr_len < t_full // 2:
            raise ValueError(f'interp_real needs at least {t_full // 2} '
                             f'source frames, not {curr_len}')
        last_tt = (curr_len - t_full // 2) // (t_full // 4)
        outs = []
        for tt in range(last_tt + 1):
            lo = (t_full // 4) * tt
            src = grid[:, lo:lo + t_full // 2]
            src_full = torch.cat([src, torch.zeros_like(src)],
                                 dim=1).reshape(b, -1)
            _, out = model.generate_images(
                generator, text, visual=visual,
                mask_predict_steps=mask_predict_steps, dynamic=False,
                preserve=src_full, long_mode='interp_real',
                mp_config=mp_config, decode=False)
            out_grid = out.reshape(b, t_full, n_tok)
            keep = (out_grid[:, :t_full - 1] if tt == last_tt
                    else out_grid[:, :t_full // 2])
            outs.append(keep)
        grid = torch.cat(outs, dim=1)

    total = grid.shape[1]
    frames = decode_frames(model, grid.reshape(b * total, n_tok))
    return frames.reshape((b, total) + frames.shape[1:])


@torch.no_grad()
def visualize_long(model, batch: Dict, generator: torch.Generator,
                   out_dir: str, *, long_mode: str = 'long',
                   t_repeat: int = 10, t_overlap: int = 1,
                   mask_predict_steps: int = 0, mp_config=None,
                   webpage: Optional[HTML] = None) -> np.ndarray:
    """Driver for the three long-video modes (utils_train.py:1220-1654):
    writes ``long_{i}.png`` (the frames in a row) for each sample, and the
    page's rows when ``webpage`` is given; returns the videos [B, F, H, W,
    3] on the host."""
    os.makedirs(out_dir, exist_ok=True)
    dev = next(model.parameters()).device
    text = torch.as_tensor(np.asarray(batch['text']), device=dev).long()
    visual = (torch.as_tensor(np.asarray(batch['visual']),
                              dtype=torch.float32, device=dev)
              if batch.get('visual') is not None
              and model.cfg.num_visuals > 0 else None)

    if long_mode == 'long':
        video = generate_long_video(
            model, generator, text, visual, t_repeat=t_repeat,
            t_overlap=t_overlap, mask_predict_steps=mask_predict_steps,
            mp_config=mp_config)
    elif long_mode == 'interp':
        # reference runs t_repeat levels where level 0 is the base
        # generation, so t_repeat-1 doubling passes (utils_train.py:1374)
        video = generate_interpolated_video(
            model, generator, text, visual, levels=max(t_repeat - 1, 1),
            mask_predict_steps=mask_predict_steps, mp_config=mp_config)
    elif long_mode == 'interp_real':
        source = model.get_image_tokens(torch.as_tensor(
            np.asarray(batch['target']), dtype=torch.float32, device=dev))
        video = generate_interp_real_video(
            model, generator, text, source, visual,
            t_repeat=max(t_repeat, 2),
            mask_predict_steps=mask_predict_steps, mp_config=mp_config)
    else:
        raise NotImplementedError(long_mode)

    captions = batch.get('description', [''] * len(video))
    for i in range(video.shape[0]):
        save_image_array(os.path.join(out_dir, f'long_{i}.png'),
                         tile_video_row(video[i]))
        if webpage is not None:
            name = webpage.save_media(f'long_{i}.gif', video[i])
            webpage.add_media_row([(name, captions[i])])
    if webpage is not None:
        webpage.save()
    return video
