"""Scene builders: procedural benchmark scenes."""
