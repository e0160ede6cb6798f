#!/usr/bin/env python
"""Generate per-element reference docs of the port from its live registry.

Counterpart of the JAX package's ``tools/gen_element_docs.py``.  The
property tables are generated by introspecting every element the port
registers, merged with the curated descriptions below, so the docs cannot
drift from the code: ``--check`` fails whenever a committed page differs
from what the generator writes (rerun it and commit).  The pages go to
``nnstreamer_tpu_torch/docs/elements/``, never to the JAX package's
``Documentation/elements/``.

Usage:  python -m nnstreamer_tpu_torch.tools.gen_element_docs          # writes the pages
        python -m nnstreamer_tpu_torch.tools.gen_element_docs --check  # exit 1 if out of date
"""

from __future__ import annotations

import inspect
import os
import sys

#: the port's element pages, beside the package's code
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "elements")

# Property descriptions.  Key: ("<element>"|"*", "<prop>").  Element-
# specific entries win over "*" wildcards.
PROP_DOCS = {
    # -- shared -----------------------------------------------------------
    ("*", "caps"): "Output caps (string or Caps) when the stream format "
        "cannot be inferred; e.g. `other/tensors,dimensions=3:224:224:1,"
        "types=uint8`.",
    ("*", "spec"): "Output TensorsSpec (alternative to `caps`).",
    ("*", "num_buffers"): "Stop after this many buffers (−1/0 = unlimited; "
        "parity: GstBaseSrc num-buffers).",
    ("*", "silent"): "Suppress per-buffer logging.",
    ("*", "location"): "File path.",
    ("*", "json"): "Path of the JSON dataset descriptor (field names follow "
        "the reference: `gst_caps`, `total_samples`, `sample_size`, "
        "`sample_offset`, `tensor_size`, `tensor_count`).",
    # -- appsrc/appsink/queue/debug/sink ---------------------------------
    ("appsrc", "max_buffers"): "Bound of the internal buffer queue; "
        "`push_buffer` blocks when full.",
    ("appsink", "max_buffers"): "Bound of the pull queue.",
    ("appsink", "drop"): "Drop the oldest buffer instead of blocking when "
        "the queue is full.",
    ("queue", "max_size_buffers"): "Queue capacity in buffers.",
    ("queue", "leaky"): "`upstream`/`downstream` to drop instead of block "
        "when full ('' = block).",
    ("queue", "prefetch_host"): "Start each enqueued buffer's card→host "
        "copy on a side stream into pinned memory, after the producer's "
        "queued work; a host consumer on the other side of the queue "
        "finds the payload there instead of draining it itself "
        "(overlaps the copy with the next window). Host tensors and "
        "buffers a `leaky` queue drops are never copied.",
    ("filesrc", "blocksize"): "Bytes per buffer (0 = whole file in one "
        "buffer).",
    ("tensor_sink", "callback"): "Python callable invoked per buffer "
        "(`new-data` signal analog).",
    ("tensor_sink", "emit_signal"): "Whether to invoke connected callbacks.",
    ("tensor_sink", "sync"): "Block until each buffer's device work "
        "completes before the callback (accurate timing, lower overlap).",
    ("tensor_debug", "output_mode"): "`console` or `none` (parity: "
        "GST_TENSOR_DEBUG_OUTPUT).",
    # -- converter / transform / decoder / filter ------------------------
    ("tensor_converter", "frames_per_tensor"): "Batch this many media "
        "frames into one tensor (parity: frames-per-tensor).",
    ("tensor_converter", "input_dim"): "Dimension string for "
        "application/octet-stream input, e.g. `3:224:224:1`.",
    ("tensor_converter", "input_type"): "Element type for octet input, "
        "e.g. `uint8`.",
    ("tensor_converter", "set_timestamp"): "Synthesize PTS when the "
        "incoming buffer has none.",
    ("tensor_converter", "mode"): "External converter sub-plugin: "
        "`flexbuf`/`flatbuf`/`protobuf`, `custom-code:<registered>` or "
        "`custom-script:<path>` (python3 converter analog).",
    ("tensor_transform", "mode"): "One of `dimchg`, `typecast`, "
        "`arithmetic`, `transpose`, `stand`, `clamp`, `padding`.",
    ("tensor_transform", "option"): "Mode option string, reference "
        "grammar; e.g. `typecast:float32,add:-127.5,div:127.5` for "
        "arithmetic (multiple ops run as one chain; fused into a "
        "downstream torch-cuda filter's program).",
    ("tensor_transform", "acceleration"): "Let an affine arithmetic "
        "chain fold into the `cuda` backend's kernel (the reference's "
        "ORC flag); off = plain tensor ops.",
    ("tensor_transform", "backend"): "`torch` (default, plain tensor "
        "ops) or `cuda` (the hand-written scale/bias/cast kernel, "
        "ops/kernels.py); `xla`/`pallas` are accepted as aliases.",
    ("tensor_transform", "donate"): "Hand the input frame over: "
        "shape/type-preserving float chains run in place on the input's "
        "card memory instead of allocating per frame; the consumed "
        "input is marked and a re-read raises DonatedTensorError.",
    ("tensor_decoder", "mode"): "Decoder sub-plugin: one of the modes "
        "listed by `python -m nnstreamer_tpu_torch.check` (e.g. "
        "`bounding_boxes`, `image_labeling`, `direct_video`, `pose`, ...).",
    ("tensor_filter", "framework"): "Filter sub-plugin: `torch-cuda` "
        "(flagship), `pytorch`, `custom`, `custom-easy`, `python3`, and the "
        "importers `onnx` (alias `onnxruntime`), `tensorflow-lite` (alias "
        "`tensorflow2-lite`) and `tensorflow` (alias `tensorflow2`), which "
        "rebuild a model file as a PyTorch function on the torch-cuda "
        "machinery; `auto` detects from the model file extension + conf "
        "priority (`.onnx`, `.tflite`, `.pb` go to the importers).",
    ("tensor_filter", "model"): "Model path / registered name / callable "
        "(framework-dependent; torch-cuda loads a registered model or a "
        "weights file, `.npz`/`.safetensors`/`.pkl`, optionally as "
        "`file://…@version`; the importers load `.onnx`, `.tflite` and "
        "frozen `.pb` graphs).",
    ("tensor_filter", "custom"): "Free-form custom properties "
        "(`key:value,...`): `donate` (torch-cuda); `qmode:` of the "
        "importers — onnx `bf16` (default) / `dequant` (integer codes, "
        "float32 sums: exact below 2**24) / `int8` (exact integer sums, "
        "in float64) / `float`; tensorflow-lite `auto` (default: `bf16` "
        "on a quantized graph, which rounds real values to bf16 and is "
        "approximate) / `bf16` / `dequant` (integer codes, float32 sums: "
        "exact below 2**24) / `float`. The importers keep PyTorch's TF32 "
        "switches: under its default, the `float` modes' convolutions "
        "take TF32 operands on the card (tolerances in the importer "
        "modules' docs).",
    ("tensor_filter", "accelerator"): "Accelerator preference string "
        "(parity: `true:gpu`); `gpu`/`cuda` runs on the card, `cpu` on "
        "the host, '' on the pipeline's device.",
    ("tensor_filter", "input_combination"): "Select/reorder input tensors "
        "fed to the model, e.g. `i0,i2` (parity: input-combination).",
    ("tensor_filter", "output_combination"): "Assemble output buffer from "
        "inputs and model outputs, e.g. `i0,o0`.",
    ("tensor_filter", "invoke_dynamic"): "Allow per-buffer output shapes "
        "(flexible output caps; the program re-specializes per "
        "schema).",
    ("tensor_filter", "is_updatable"): "Enable RELOAD_MODEL: the new "
        "weights are placed and warmed before the swap, invokes never "
        "stall.",
    ("tensor_filter", "shared_tensor_filter_key"): "Instances sharing this "
        "key on one device share one model and program (parity: shared "
        "model representation).",
    ("tensor_filter", "latency"): "1 = measure per-invoke device latency "
        "(a CUDA event synchronize per invoke) and expose the `latency` "
        "property.",
    ("tensor_filter", "latency_report"): "Post LATENCY messages on the "
        "bus (parity: latency-report).",
    ("tensor_filter", "inputtype"): "Override model input types (SET_INPUT_"
        "INFO path), comma-separated.",
    ("tensor_filter", "input"): "Override model input dimensions, e.g. "
        "`3:224:224:1`.",
    ("tensor_filter", "outputtype"): "Override model output types.",
    ("tensor_filter", "output"): "Override model output dimensions.",
    ("tensor_filter", "mesh"): "Mesh placement: axis spec like "
        "`data:4,model:2` (or `data:-1` to absorb every device) — the "
        "invoke splits its batch over the `data` axis in contiguous rows "
        "and runs each shard on its device. `dcn.`-prefixed leading "
        "axes span the PROCESSES of a torch.distributed group "
        "(`dcn.data:2,data:4` = 2 processes x 4 local devices, the "
        "multi-process pool placement). Equivalent spellings resolve to "
        "ONE canonical placement (parallel/placement.py), so `data:-1` "
        "and `data:8` on 8 devices share pools and instances.",
    ("tensor_filter", "sharding"): "Named parameter-layout rule set from "
        "nnstreamer_tpu_torch.parallel.PARAM_RULES (e.g. `tp`: pointwise "
        "convolutions and dense products split over `model`); requires "
        "`mesh`. Alias names resolving to the same rules (`dp`/"
        "`replicated`) are one canonical placement.",
    ("tensor_filter", "devices"): "Device-index subset for `mesh` "
        "(`0-3`, `4,5,6,7`): lays the mesh over those devices so two "
        "filter stages occupy disjoint devices with a device-to-device "
        "handoff between them (the pipeline split; requires `mesh`; not "
        "combinable with `dcn.` axes).",
    ("tensor_filter", "batch"): "Dynamic micro-batching window: coalesce "
        "up to this many in-flight buffers into ONE program call "
        "(1 = off, the unbatched hot path). Put a `queue` in front so "
        "the window can fill; see Documentation/batching.md.",
    ("tensor_filter", "batch_timeout_ms"): "Deadline of the coalescing "
        "window: a partial batch dispatches this many ms after its first "
        "buffer arrived (bounds the latency batching can add).",
    ("tensor_filter", "batch_buckets"): "Comma list of padded batch "
        "sizes (e.g. `2,4,8`): partial windows pad up to the smallest "
        "bucket, so the card sees one shape per bucket, not per "
        "window size ('' = powers of two up to `batch`).",
    ("tensor_filter", "share_model"): "Attach to the process-wide "
        "ModelPool: filters on the same model share ONE sub-plugin "
        "instance (one params copy, one executable cache) and, with "
        "`batch>1`, one CROSS-pipeline coalescing window with adaptive "
        "idle flush. `batch*` properties become pool-level (sharers "
        "must agree); see Documentation/serving.md.",
    ("tensor_filter", "stat_sample_interval_ms"): "Cadence of the "
        "blocking latency sample feeding InvokeStats (at most one "
        "device-synchronized sample per interval; other invokes stay "
        "async). Unset = the class default STAT_SAMPLE_INTERVAL "
        "(1000 ms). Shrink for a fresher `nns-top` latency column, "
        "grow to make sampling arbitrarily rare; the obs metrics "
        "registry reads the result at scrape time "
        "(Documentation/observability.md). With `share-model=true` the "
        "POOL's sampling cadence is the minimum across its sharers' "
        "settings.",
    ("tensor_filter", "priority"): "This STREAM's admission class on a "
        "shared pool (`high`/`normal`/`low`): `high` is never shed; "
        "lower classes shed first while the pool's p99 threatens the "
        "SLO (Documentation/robustness.md).",
    ("tensor_filter", "deadline_ms"): "Per-stream EDF deadline: while "
        "admission is armed, window formation is earliest-deadline-"
        "first, so tighter deadlines dispatch first under contention "
        "(0 = the pool's `slo-ms`).",
    ("tensor_filter", "slo_ms"): "POOL-level p99 SLO (sharers must "
        "agree, like `batch*`): >0 arms the admission controller — "
        "graded load shedding of sub-high-priority frames as the "
        "pool's p99 serve latency approaches this bound; every shed "
        "is counted and bus-warned (Documentation/robustness.md).",
    ("tensor_filter", "queue_limit"): "Bound on this stream's frames "
        "parked in the shared window (0 = 16x `batch`); past it the "
        "producer thread blocks — the backpressure that fills the "
        "upstream queue instead of growing the window unboundedly.",
    ("tensor_filter", "canary"): "POOL-level canary routing "
        "declaration (`<version>:1/N` or `1/N`, sharers must agree): "
        "a model reload on the shared pool routes 1-in-N STREAMS to "
        "the staged version instead of cutting every stream over; "
        "nns-watch comparator rules on the exported "
        "canary-vs-baseline series drive promote-or-rollback through "
        "nns-ctl playbooks (Documentation/lifecycle.md).",
    ("tensor_filter", "tenant"): "This STREAM's billing identity on a "
        "shared pool ('' = `default`, requires `share-model=true` — "
        "NNS517 otherwise): every pooled dispatch's device-seconds "
        "are split EXACTLY across the tenants whose frames rode in "
        "it, exported as the `nns_tenant_*` families plus scrape-time "
        "dollars priced by `NNS_TPU_TORCH_CHIP_HOUR_USD`/hwspec, and "
        "`nns-ctl` playbooks can scope to one tenant's alerts "
        "(Documentation/observability.md).",
    ("tensor_filter", "chaos"): "Element-scoped fault injection plan "
        "(grammar in chaos/plan.py, e.g. "
        "`seed=7;slow-invoke:ms=20,p=0.1`) applied at THIS element's "
        "dispatch; the process-wide `NNS_TPU_TORCH_CHAOS` plan applies "
        "regardless (Documentation/robustness.md).",
    # -- combiners --------------------------------------------------------
    ("tensor_mux", "sync_mode"): "`nosync`, `slowest`, `basepad`, or "
        "`refresh` (reference sync policies).",
    ("tensor_mux", "sync_option"): "Mode option (basepad: "
        "`<pad>:<duration>`).",
    ("tensor_merge", "mode"): "`linear` (dimension concatenation).",
    ("tensor_merge", "option"): "Concat dimension index (innermost-first, "
        "reference order).",
    ("tensor_demux", "tensorpick"): "Comma list selecting/reordering "
        "output tensors, e.g. `0,2` ('' = one pad per tensor).",
    ("tensor_split", "tensorseg"): "Colon list of per-output sizes along "
        "`dimension`, e.g. `2:1:1` (reference tensorseg grammar).",
    ("tensor_split", "dimension"): "Dimension index to split along "
        "(innermost-first).",
    ("tensor_crop", "lateness"): "Max pts distance (ns) between raw and "
        "crop-info buffers considered the same frame.",
    ("tensor_crop", "sync_mode"): "Synchronization policy for the two "
        "sink pads (see tensor_mux).",
    ("tensor_crop", "sync_option"): "Sync-mode option.",
    ("tensor_aggregator", "frames_in"): "Frames per incoming buffer along "
        "`frames_dim`.",
    ("tensor_aggregator", "frames_out"): "Frames per outgoing buffer.",
    ("tensor_aggregator", "frames_flush"): "Frames dropped from the window "
        "after each output (0 = frames_out).",
    ("tensor_aggregator", "frames_dim"): "Aggregation dimension "
        "(innermost-first; None = last).",
    ("tensor_aggregator", "concat"): "Concatenate along frames_dim (vs. "
        "stack).",
    # -- tensor_if --------------------------------------------------------
    ("tensor_if", "compared_value"): "`A_VALUE`, `TENSOR_TOTAL`, "
        "`ALL_TOTAL`, `AVERAGE`, `ALL_AVERAGE`, or `CUSTOM` (registered "
        "callback).",
    ("tensor_if", "compared_value_option"): "Which value, e.g. "
        "`<tensor>:<index>` for A_VALUE, or the custom callback name.",
    ("tensor_if", "supplied_value"): "Constant(s) to compare against "
        "(`v` or `v1:v2` for ranges).",
    ("tensor_if", "operator"): "`eq ne gt ge lt le in out` (+ranges), "
        "reference operator set.",
    ("tensor_if", "then"): "`PASSTHROUGH`, `SKIP`, `FILL_ZERO`, "
        "`FILL_VALUES`, `REPEAT_PREV`, `TENSORPICK`.",
    ("tensor_if", "then_option"): "Behavior option (fill values / pick "
        "list).",
    ("tensor_if", "else_"): "Behavior when the condition is false (same "
        "set as `then`).",
    ("tensor_if", "else_option"): "Else-behavior option.",
    ("tensor_if", "offload"): "Conditional-cascade marker: `then` or "
        "`else` names the branch that feeds the HEAVY stage of a "
        "pipeline split (detector → tensor_if → cross-subset "
        "classifier). Every routing decision then counts into the "
        "stage store — `nns_cascade_offload_ratio` is the fraction of "
        "frames that paid for the heavy model. See "
        "Documentation/serving.md \"Pipeline-split serving\".",
    # -- rate / repo / sparse --------------------------------------------
    ("tensor_rate", "framerate"): "Target output rate `N/D`.",
    ("tensor_rate", "throttle"): "Send QoS throttle events upstream so "
        "tensor_filter skips invokes (parity: throttle).",
    ("tensor_reposink", "slot"): "Repository slot index shared with a "
        "tensor_reposrc (cyclic graphs).",
    ("tensor_reposrc", "slot"): "Repository slot index to read.",
    ("tensor_reposrc", "timeout"): "Seconds to wait for the slot before "
        "erroring.",
    ("tensor_reposrc", "dummy_first"): "Emit one zero buffer first so the "
        "loop can start (reference behavior).",
    # -- datarepo ---------------------------------------------------------
    ("datareposrc", "start_sample_index"): "First sample of the read "
        "window.",
    ("datareposrc", "stop_sample_index"): "Last sample (None = end).",
    ("datareposrc", "epochs"): "Number of passes over the window (0 = "
        "forever).",
    ("datareposrc", "is_shuffle"): "Shuffle sample order each epoch.",
    ("datareposrc", "tensors_sequence"): "Select/reorder tensors per "
        "sample, e.g. `1,0`.",
    ("datareposrc", "seed"): "Shuffle RNG seed.",
    # -- trainer ----------------------------------------------------------
    ("tensor_trainer", "framework"): "Trainer sub-plugin (`torch-optim` "
        "flagship).",
    ("tensor_trainer", "model_config"): "Model/optimizer config (dict or "
        "JSON path) interpreted by the sub-plugin.",
    ("tensor_trainer", "model_save_path"): "Where the trained params are "
        "saved on completion.",
    ("tensor_trainer", "model_load_path"): "Warm-start params.",
    ("tensor_trainer", "num_inputs"): "Leading tensors of each sample "
        "that are model inputs.",
    ("tensor_trainer", "num_labels"): "Following tensors that are labels.",
    ("tensor_trainer", "num_training_samples"): "Training samples per "
        "epoch.",
    ("tensor_trainer", "num_validation_samples"): "Validation samples per "
        "epoch.",
    ("tensor_trainer", "epochs"): "Total epochs; EOS is held until "
        "training completes.",
    ("tensor_trainer", "completion_timeout"): "Seconds to wait for "
        "epoch/training completion before erroring.",
    # -- sources ----------------------------------------------------------
    ("device_src", "pattern"): "`noise`, `zeros`, `ones`, `ramp`, or "
        "`counter` — frames generated ON the device (no host copy).",
    ("device_src", "frames"): "Optional ndarray cycled as the stream.",
    ("device_src", "pool_size"): "Device-resident buffer pool depth.",
    ("device_src", "fps"): "Paced emission rate (None = free-run).",
    ("tensor_src_sensor", "device_dir"): "IIO-style sysfs directory "
        "(scan_elements/, in_*_raw, sampling_frequency).",
    ("tensor_src_sensor", "sensor"): "Callback-registered sensor name "
        "(Tizen sensor-framework analog).",
    ("tensor_src_sensor", "channels"): "`auto` (enabled scan_elements) or "
        "explicit channel list.",
    ("tensor_src_sensor", "frequency"): "Sampling frequency (0 = device "
        "default).",
    ("tensor_src_sensor", "merge_channels_data"): "One multi-channel "
        "tensor per sample instead of one tensor per channel.",
    ("tensor_src_sensor", "buffer_capacity"): "Samples per buffer.",
    ("tensor_src_sensor", "process"): "Apply scale/offset to raw values.",
    ("capsfilter", "caps"): "Caps the stream must satisfy (negotiation "
        "constraint).",
}

EXAMPLES = {
    "tensor_filter": "device_src spec=3:224:224:64 ! tensor_transform "
        "mode=arithmetic option=typecast:float32,div:255.0 ! queue ! "
        "tensor_filter framework=torch-cuda model=mobilenet_v2 batch=8 ! "
        "tensor_sink",
    "tensor_transform": "appsrc ! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! tensor_sink",
    "tensor_decoder": "... ! tensor_filter framework=torch-cuda model=ssd ! "
        "tensor_decoder mode=bounding_boxes "
        "option1=mobilenet-ssd-postprocess option4=640:480 option7=device "
        "! tensor_sink",
    "queue": "... ! tensor_filter framework=torch-cuda model=ssd ! "
        "queue prefetch-host=true ! tensor_decoder mode=bounding_boxes "
        "option1=mobilenet-ssd-postprocess option4=640:480 ! appsink",
    "datareposrc": "datareposrc location=train.dat json=train.json "
        "epochs=10 ! tensor_trainer framework=torch-optim num-inputs=1 "
        "num-labels=1 num-training-samples=500 epochs=10 "
        "model-save-path=out.ckpt ! tensor_sink",
    "tensor_if": "appsrc ! tensor_if compared-value=A_VALUE "
        "compared-value-option=0:0 supplied-value=0.5 operator=ge "
        "then=PASSTHROUGH else=SKIP ! tensor_sink",
    "tensor_mux": "tensor_mux name=m sync-mode=slowest ! tensor_sink "
        "appsrc ! m.sink_0 appsrc ! m.sink_1",
}


def _prop_doc(element: str, prop: str) -> str:
    return PROP_DOCS.get((element, prop)) or PROP_DOCS.get(("*", prop)) or ""


def _first_paragraph(doc: str) -> str:
    if not doc:
        return ""
    paras = [p.strip() for p in doc.split("\n\n") if p.strip()]
    return " ".join(paras[0].split()) if paras else ""


def _type_name(default) -> str:
    if default is None:
        return "-"
    if isinstance(default, bool):
        return "bool"
    if isinstance(default, int):
        return "int"
    if isinstance(default, float):
        return "float"
    if isinstance(default, str):
        return "str"
    return type(default).__name__


def generate() -> dict:
    from nnstreamer_tpu_torch.runtime.registry import element_factory, list_elements

    pages = {}
    index_rows = []
    for name in list_elements():
        if name.startswith("_"):
            continue  # private/test-only factories stay undocumented
        cls = element_factory(name)
        sig = inspect.signature(cls.__init__)
        props = [p for p in sig.parameters.values()
                 if p.name not in ("self", "name", "props")
                 and p.kind != inspect.Parameter.VAR_KEYWORD]
        # cls.__doc__, not inspect.getdoc: the latter inherits the base
        # Element docstring for undocumented classes
        summary = _first_paragraph(cls.__doc__
                                   or sys.modules[cls.__module__].__doc__
                                   or "")
        lines = [f"# {name}", "",
                 f"Class: `{cls.__module__}.{cls.__name__}`", ""]
        if summary:
            lines += [summary, ""]
        if props:
            lines += ["## Properties", "",
                      "Properties use `-` in pipeline strings "
                      "(`max-size-buffers=4`) and `_` in Python "
                      "(`max_size_buffers=4`).", "",
                      "| Property | Type | Default | Description |",
                      "|---|---|---|---|"]
            for p in props:
                pd = _prop_doc(name, p.name).replace("|", "\\|")
                dflt = "required" if p.default is inspect.Parameter.empty \
                    else f"`{p.default!r}`"
                lines.append(
                    f"| `{p.name.rstrip('_').replace('_', '-')}` | "
                    f"{_type_name(p.default)} | {dflt} | {pd} |")
            lines.append("")
        else:
            lines += ["## Properties", "", "(none)", ""]
        if name == "tensor_decoder":
            from nnstreamer_tpu_torch.decoders import list_decoders

            lines += ["## Modes", "",
                      "`" + "`, `".join(list_decoders()) + "`", "",
                      "Options `option1`..`option9` configure the mode "
                      "(reference grammar; see the decoder module "
                      "docstrings in `nnstreamer_tpu_torch/decoders/`).", ""]
        if name == "tensor_filter":
            from nnstreamer_tpu_torch.filters.registry import list_filters

            lines += ["## Frameworks", "",
                      "`" + "`, `".join(list_filters()) + "`", ""]
        if name in EXAMPLES:
            lines += ["## Example", "", "```",
                      EXAMPLES[name], "```", ""]
        lines += ["---", "*Generated by `python -m "
                  "nnstreamer_tpu_torch.tools.gen_element_docs` — "
                  "do not edit by hand; rerun after changing element "
                  "properties.*", ""]
        pages[f"{name}.md"] = "\n".join(lines)
        index_rows.append(
            f"| [{name}]({name}.md) | {len(props)} | "
            f"{summary[:90].replace('|', ' ')}{'…' if len(summary) > 90 else ''} |")

    idx = ["# Element reference", "",
           "One page per registered element, generated from the live "
           "registry of the PyTorch/CUDA port (`python -m "
           "nnstreamer_tpu_torch.tools.gen_element_docs`).  "
           f"{len(index_rows)} elements.", "",
           "| Element | Props | Summary |", "|---|---|---|"]
    idx += index_rows + [""]
    pages["README.md"] = "\n".join(idx)
    return pages


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    check = "--check" in argv
    pages = generate()
    if not check:
        os.makedirs(OUT_DIR, exist_ok=True)
    stale = []
    for fname, content in pages.items():
        path = os.path.join(OUT_DIR, fname)
        old = None
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                old = f.read()
        if old != content:
            stale.append(fname)
            if not check:
                with open(path, "w", encoding="utf-8") as f:
                    f.write(content)
    if check:
        if stale:
            print("element docs out of date:", ", ".join(stale))
            return 1
        print("element docs up to date")
        return 0
    print(f"wrote {len(pages)} pages to {OUT_DIR} "
          f"({len(stale)} changed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
