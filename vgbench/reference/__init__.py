"""The plain reference of the benchmark's frames: a recorder of the vg::
draw calls (frozen copies of the port's host semantics: paths, strokes,
paints, text) and a rasterizer in plain torch.  It imports nothing of the
program (vgtpu_torch), of jax or of vgtpu."""
