"""Training (so far: the renderer factory the trainers and inference share)."""
