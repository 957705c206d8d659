"""Step builders (``steps``) on one device or on a mesh, and the mesh
primitives they use (``spmd``: local functions over DTensor shards;
``host_staged``: gloo collectives on CUDA tensors through the host)."""
