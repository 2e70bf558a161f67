from a2m_torch.eval.harness import evaluate_speaker
from a2m_torch.eval.metrics import (compute_pck, compute_pck_np,
                                    l2_pose_error, pck_radius,
                                    pose_blocks_to_keypoints)

__all__ = ['evaluate_speaker', 'compute_pck', 'compute_pck_np',
           'l2_pose_error', 'pck_radius', 'pose_blocks_to_keypoints']
