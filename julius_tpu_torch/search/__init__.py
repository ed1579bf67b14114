"""Search: decode network, device N-gram hash, pass-1 beam, pass-2 stack."""
