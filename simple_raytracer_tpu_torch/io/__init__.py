"""Files of the port: images (``image.py``), STL and OBJ meshes
(``stl.py``, ``obj.py``) and scene files (``scene_json.py``)."""
