"""Compute: DNN senone scorer and the pass-1 beam-update kernel."""
