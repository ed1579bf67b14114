from julius_tpu_torch.models.hmm import HMMSet, PseudoPhoneSets  # noqa: F401
