"""Client meshes and the client-stacked placement rules of the sharded
GLASU backend."""
