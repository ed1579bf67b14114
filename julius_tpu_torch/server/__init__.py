"""Network servers: the module control/result protocol, adinnet audio
input and vecnet feature input (host code, byte-compatible with the
reference's julius_tpu/server/)."""
