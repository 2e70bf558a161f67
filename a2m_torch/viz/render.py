"""Skeleton rendering + side-by-side video export.

The port's own copy of ``a2m/viz/render.py``.  Capability parity with
`generate_motion_video.py:23-207`: matplotlib skeleton drawing (head
purple, right body gray, left body blue, left hand red, right hand yellow),
per-frame JPEGs, side-by-side prediction/GT layout, ffmpeg
muxing at 30000/1001 fps, audio muxing.

Deviations, deliberate:
* keypoint groups come from :mod:`a2m_torch.constants` for the 52-joint
  skeleton; the reference reuses legacy 49-joint constants whose
  right-hand finger indices (`pose_video/consts.py:8`, 29+4x) are off by 3
  in the 52-joint layout and draw the right hand wrong;
* when ffmpeg is absent the writer falls back to an animated GIF via PIL so
  the pipeline is runnable hermetically.

matplotlib (Agg backend) and PIL are imported by the drawing functions when
they run, not when this module is imported: a machine without them (as the
H100 machine may be) imports the package, serves and trains; only drawing
needs them.
"""

from __future__ import annotations

import functools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

LINE_WIDTH = 1.5

# 52-joint skeleton groups (a2m_torch.constants.PARENTS)
BASE_KEYPOINT = [0]
RIGHT_BODY_KEYPOINTS = [1, 2, 3, 31]        # RShoulder..RWrist..RHandRoot
LEFT_BODY_KEYPOINTS = [4, 5, 6, 10]         # LShoulder..LWrist..LHandRoot
LEFT_HAND_KEYPOINTS = lambda f: [10] + [11 + f * 4 + j for j in range(4)]  # noqa: E731
RIGHT_HAND_KEYPOINTS = lambda f: [31] + [32 + f * 4 + j for j in range(4)]  # noqa: E731
HEAD_KEYPOINTS = [(7, 8), (7, 9)]           # Nose->REye, Nose->LEye


@functools.lru_cache(maxsize=1)
def _pyplot():
    """matplotlib's pyplot on the Agg backend (imported on first use)."""
    import matplotlib
    matplotlib.use('Agg')
    from matplotlib import pyplot
    return pyplot


def _image():
    from PIL import Image
    return Image


def _plot_chain(keypoints, idx, color, alpha=None,
                line_width=LINE_WIDTH) -> None:
    idx = np.asarray(idx)
    _pyplot().plot(keypoints[0][idx], keypoints[1][idx],
                   linewidth=line_width, alpha=alpha, color=color)


def draw_pose(keypoints, img=None, img_width=1280, img_height=720,
              output=None, title=None, title_x=1.0, alpha_img=0.5,
              alpha_keypoints=None, fig=None,
              line_width=LINE_WIDTH):
    """Draw one (2, 52) pose on a blank or background image
    (generate_motion_video.py:103-136)."""
    plt, Image = _pyplot(), _image()
    if fig is None:
        plt.close('all')
        fig = plt.figure(figsize=(6, 4))
    plt.axis('off')
    if img is not None:
        img = Image.open(img)
        img_width, img_height = img.size
    else:
        img = Image.new(mode='RGB', size=(img_width, img_height),
                        color='white')
    plt.imshow(img, alpha=alpha_img)

    for a, b in HEAD_KEYPOINTS:
        _plot_chain(keypoints, [a, b], 'purple', alpha_keypoints, line_width)
    _plot_chain(keypoints, RIGHT_BODY_KEYPOINTS, 'gray', alpha_keypoints,
                line_width)
    _plot_chain(keypoints, LEFT_BODY_KEYPOINTS, 'blue', alpha_keypoints,
                line_width)
    for f in range(5):
        _plot_chain(keypoints, LEFT_HAND_KEYPOINTS(f), 'red',
                    alpha_keypoints, line_width)
        _plot_chain(keypoints, RIGHT_HAND_KEYPOINTS(f), 'yellow',
                    alpha_keypoints, line_width)

    ax = fig.get_axes()[0]
    ax.set_xlim(0, img_width)
    ax.set_ylim(img_height, 0)
    if title:
        plt.title(title, x=title_x)
    if output:
        plt.savefig(output)
        plt.close()
    return fig


def draw_side_by_side_poses(keypoints1, keypoints2, output=None,
                            title='Prediction %s Ground Truth' % (7 * ' '),
                            img_size=(3000, 1000), dpi=200):
    """Two skeletons on one canvas (generate_motion_video.py:139-164)."""
    plt, Image = _pyplot(), _image()
    plt.close('all')
    fig = plt.figure(figsize=(6, 4), dpi=dpi)
    plt.axis('off')
    if title:
        plt.title(title)
    img = Image.new(mode='RGB', size=img_size, color='white')
    plt.imshow(img, alpha=0.5)
    for keypoints in (keypoints1, keypoints2):
        for a, b in HEAD_KEYPOINTS:
            _plot_chain(keypoints, [a, b], 'purple')
        _plot_chain(keypoints, RIGHT_BODY_KEYPOINTS, 'gray')
        _plot_chain(keypoints, LEFT_BODY_KEYPOINTS, 'blue')
        for f in range(5):
            _plot_chain(keypoints, LEFT_HAND_KEYPOINTS(f), 'red')
            _plot_chain(keypoints, RIGHT_HAND_KEYPOINTS(f), 'yellow')
    if output is not None:
        plt.savefig(output)
    return fig


def have_ffmpeg() -> bool:
    return shutil.which('ffmpeg') is not None


def create_mute_video_from_images(output_fn, temp_folder) -> None:
    """ffmpeg image2 -> video at 30000/1001 fps
    (generate_motion_video.py:192-200); GIF fallback without ffmpeg."""
    pattern = os.path.join(temp_folder, '%04d.jpg')
    if have_ffmpeg():
        subprocess.call(
            f'ffmpeg -loglevel panic -r 30000/2002 -f image2 -i "{pattern}" '
            f'-r 30000/1001 "{output_fn}" -y', shell=True)
        return
    Image = _image()
    frames = sorted(Path(temp_folder).glob('*.jpg'))
    imgs = [Image.open(f) for f in frames]
    gif = str(Path(output_fn).with_suffix('.gif'))
    if imgs:
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=int(1000 * 2002 / 30000), loop=0)


def save_video_from_audio_video(audio_input_path, input_video_path,
                                output_video_path) -> None:
    """Mux audio into a rendered video (generate_motion_video.py:203-207)."""
    if not have_ffmpeg():
        raise RuntimeError('ffmpeg is required for audio muxing')
    subprocess.call(
        f'ffmpeg -loglevel panic -i "{audio_input_path}" '
        f'-i "{input_video_path}" -strict -2 "{output_video_path}" -y',
        shell=True)


def save_side_by_side_video(temp_folder, keypoints1, keypoints2, output_fn,
                            delete_tmp: bool = True) -> None:
    """Frame loop + mux (generate_motion_video.py:167-190).

    keypoints1/2: sequences of (2, 52) arrays; extra leading frames of
    keypoints2 are rendered alone as conditioning context.
    """
    os.makedirs(temp_folder, exist_ok=True)
    out_dir = os.path.dirname(output_fn)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    pattern = os.path.join(temp_folder, '%04d.jpg')

    diff = len(keypoints2) - len(keypoints1)
    if diff > 0:
        conditioned = keypoints2[:diff]
        keypoints2 = keypoints2[diff:]
        for i in range(len(conditioned)):
            draw_pose(conditioned[i], img_width=3000, img_height=1000,
                      output=pattern % i, title='Input', title_x=0.63)
    for j in range(len(keypoints1)):
        draw_side_by_side_poses(keypoints1[j], keypoints2[j],
                                output=pattern % (j + max(diff, 0)))
        _pyplot().close()

    create_mute_video_from_images(output_fn, temp_folder)
    if delete_tmp:
        shutil.rmtree(temp_folder, ignore_errors=True)


def display_transform(pose_xy: np.ndarray, scale: float = 3.0,
                      flip_y: bool = True,
                      offset=(0.0, 0.0)) -> np.ndarray:
    """Affine display transform (generate_motion_video.py:280-284): scale,
    y-flip, translate.  pose_xy: (..., 2, 52)."""
    m = np.array([[scale, 0.0], [0.0, -scale if flip_y else scale]])
    out = np.einsum('ij,...jk->...ik', m, pose_xy)
    return out + np.asarray(offset).reshape(2, 1)
