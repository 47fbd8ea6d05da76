"""Camera paths of the traffic files, one module a path, found by the name
in a traffic file's ``camera.path``.  Each has ``position(camera, frame)``
(float32 numpy), ``frames(camera)`` (frames before the path repeats) and
``first_frame(camera, word)`` (the frame a run starts at, from a 62-bit
seed word)."""
