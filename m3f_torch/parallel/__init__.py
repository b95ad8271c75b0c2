"""Training and eval across processes (``mesh``: the launch, the rank
layout, the data and model axes and their collectives; ``seqpar``: the
sharded eval and the sequence-parallel BiGRU)."""
