"""Targets of the training traffic, one module a kind, found by the name in
a traffic file's ``target``.  Each has ``make(program) -> (3, H, W)``
float32 on the program's device, from the driver's scene, camera,
configuration and seed; it uses nothing that the program made."""
