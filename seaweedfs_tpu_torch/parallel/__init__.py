"""The multi-device EC codec: a mesh of torch devices driven by one
process (mesh.py), the shard- and byte-parallel products with an XOR ring
(sharded_codec.py), and MeshCodec with the Clay and LRC mesh arms
(mesh_codec.py)."""
