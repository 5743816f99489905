"""Monocular preprocessing: a video to the training split (see
havatar_tpu/preprocess and ``cli/fit_video.py``)."""
