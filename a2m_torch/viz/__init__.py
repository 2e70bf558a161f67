"""Skeleton rendering and sample videos (the port's copy of ``a2m/viz``).
matplotlib and PIL are imported only when a function draws."""

from a2m_torch.viz.render import (create_mute_video_from_images,
                                  display_transform, draw_pose,
                                  draw_side_by_side_poses, have_ffmpeg,
                                  save_side_by_side_video,
                                  save_video_from_audio_video)

__all__ = ['create_mute_video_from_images', 'display_transform', 'draw_pose',
           'draw_side_by_side_poses', 'have_ffmpeg',
           'save_side_by_side_video', 'save_video_from_audio_video']
