"""Data-parallel training and sharded whole-video eval across processes
(``mesh``: the launch and the data axis; ``seqpar``: the sharded eval)."""
