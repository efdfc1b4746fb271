"""Launch entry points: the per-architecture optimizer choice (`cells`),
meshes over the visible cards (`mesh`), the train step (`steps`), the
training loop (`train`) and the serving command line with optional PIM
protection (`serve`)."""
