"""Audio input layer: the native trigger/VAD segmenter, decimator and
live capture (adin/native/adin.cpp through native_wrapper.py)."""
