"""Compute: DNN and GMM senone scorers and the hand-written kernels
(pass 1's beam update and word-end stage, pass 2's word scan)."""
