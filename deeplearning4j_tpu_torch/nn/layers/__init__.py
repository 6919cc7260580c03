"""Layer math shared by the layer configurations."""
