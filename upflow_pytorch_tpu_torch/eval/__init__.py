"""Evaluation of the port: the KITTI metrics and the evaluation bench."""
