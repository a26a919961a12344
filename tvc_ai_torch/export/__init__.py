"""Export of a trained actor for microcontrollers: int8 ``.tvcq`` for the
native runtime (``micro``), int8 TFLite (``tflite``), C arrays and a
TFLite-Micro example (``c_array``); ``python -m tvc_ai_torch.export`` is the
command line."""
