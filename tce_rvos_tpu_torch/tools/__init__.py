"""Tools of the port: the visualization colormap."""
