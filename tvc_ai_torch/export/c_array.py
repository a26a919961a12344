"""C-array + TFLite-Micro C++ artifact generation.

Counterpart of ``tvc_ai_tpu/export/c_array.py`` (the port keeps its own copy
of this host text): a model's bytes become a C byte array and its header,
plus a ready-to-build TFLM inference example (MicroInterpreter, a small
tensor arena, float obs in → quantize → invoke → dequantize → gimbal out).
"""

from __future__ import annotations

from pathlib import Path


def generate_c_array(
    model_bytes: bytes, output_dir: str | Path, name: str = "tvc_model"
) -> tuple[Path, Path]:
    """Write ``{name}_data.cc`` / ``.h`` with the flatbuffer bytes."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    hex_lines = []
    for i in range(0, len(model_bytes), 12):
        chunk = model_bytes[i : i + 12]
        hex_lines.append("  " + ", ".join(f"0x{b:02x}" for b in chunk) + ",")
    body = "\n".join(hex_lines)
    guard = f"{name.upper()}_DATA_H_"

    cc = output_dir / f"{name}_data.cc"
    cc.write_text(
        f'#include "{name}_data.h"\n\n'
        f"alignas(8) const unsigned char {name}_data[] = {{\n{body}\n}};\n"
        f"const unsigned int {name}_data_len = {len(model_bytes)};\n"
    )
    h = output_dir / f"{name}_data.h"
    h.write_text(
        f"#ifndef {guard}\n#define {guard}\n\n"
        f"extern const unsigned char {name}_data[];\n"
        f"extern const unsigned int {name}_data_len;\n\n"
        f"#endif  // {guard}\n"
    )
    return cc, h


def generate_tflm_example(
    output_dir: str | Path,
    obs_dim: int = 8,
    action_dim: int = 2,
    arena_size: int = 4096,
    name: str = "tvc_model",
) -> Path:
    """Emit a TFLM C++ inference example (ref :444-545 equivalent)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    path = output_dir / "inference_example.cpp"
    path.write_text(
        f"""// TVC actor inference on a microcontroller via TFLite-Micro.
// Feeds a {obs_dim}-float observation [quat(4), omega(3), fuel] and reads a
// {action_dim}-float gimbal command in [-1, 1].

#include "tensorflow/lite/micro/micro_mutable_op_resolver.h"
#include "tensorflow/lite/micro/micro_interpreter.h"
#include "tensorflow/lite/schema/schema_generated.h"
#include "{name}_data.h"

namespace {{
constexpr int kTensorArenaSize = {arena_size};
alignas(16) uint8_t tensor_arena[kTensorArenaSize];

tflite::MicroInterpreter* interpreter = nullptr;
TfLiteTensor* input = nullptr;
TfLiteTensor* output = nullptr;
}}  // namespace

bool tvc_setup() {{
  const tflite::Model* model = tflite::GetModel({name}_data);
  if (model->version() != TFLITE_SCHEMA_VERSION) return false;

  static tflite::MicroMutableOpResolver<4> resolver;
  resolver.AddFullyConnected();
  resolver.AddTanh();
  resolver.AddQuantize();
  resolver.AddDequantize();

  static tflite::MicroInterpreter static_interpreter(
      model, resolver, tensor_arena, kTensorArenaSize);
  interpreter = &static_interpreter;
  if (interpreter->AllocateTensors() != kTfLiteOk) return false;
  input = interpreter->input(0);
  output = interpreter->output(0);
  return true;
}}

// obs: {obs_dim} floats; gimbal_out: {action_dim} floats in [-1, 1].
bool tvc_infer(const float* obs, float* gimbal_out) {{
  const float in_scale = input->params.scale;
  const int in_zero = input->params.zero_point;
  for (int i = 0; i < {obs_dim}; ++i) {{
    const int32_t q =
        static_cast<int32_t>(obs[i] / in_scale + 0.5f) + in_zero;
    input->data.int8[i] = static_cast<int8_t>(
        q < -128 ? -128 : (q > 127 ? 127 : q));
  }}
  if (interpreter->Invoke() != kTfLiteOk) return false;
  const float out_scale = output->params.scale;
  const int out_zero = output->params.zero_point;
  for (int i = 0; i < {action_dim}; ++i) {{
    gimbal_out[i] = (output->data.int8[i] - out_zero) * out_scale;
  }}
  return true;
}}
"""
    )
    return path
