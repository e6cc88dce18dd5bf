"""The plain chain of the benchmark's reference: a frozen copy of the
program's plain PyTorch path (config, ops, models/esn, ldpc, pipelines,
utils/rng), with every hand-written kernel replaced by the plain form it
is tested against. It imports torch and numpy only, and nothing of the
program. TF32 is off unless a caller turns it on (the control)."""
