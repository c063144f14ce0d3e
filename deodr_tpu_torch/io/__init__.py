"""File readers of the port: Wavefront OBJ meshes and PNG textures."""
