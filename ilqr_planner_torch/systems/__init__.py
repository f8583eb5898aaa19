"""Problem specification: keypoints and the dense Spec."""
