"""Scenes: the scene-file path (``schema.parse_scene_json``, the resource
manager, the OBJ loader, the PNG decoder, ``build.build_scene``) and the
procedural benchmark scenes (``synthetic``)."""
