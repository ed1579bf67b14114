"""Device-mesh parallelism in one process: data-parallel batch decode
and tensor-split DNN scoring (mesh.py), and pass 1 over a network split
into word-aligned shards (sharded_pass1.py)."""
