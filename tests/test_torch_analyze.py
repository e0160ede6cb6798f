"""The static analyzer's tests (``tests/test_analyze.py``) replayed on the
port's ``nnstreamer_tpu_torch.analyze``, its JSON golden byte-equal.

Left out, each with every corpus entry and test of it: the
NNS509/NNS512/NNS516 cases (mesh placement and the pipeline split): the
port's ``tensor_filter`` has no ``mesh=``/``devices=``, so those
descriptions do not parse.  The NNS506/NNS507 cases and the
``tensor_query_client`` cases of NNS508 run.
"""

from torch_replay import replay

#: the catalog codes whose checks wait for mesh placement: kept in
#: ``CODES``, exercised by no corpus yet
NOT_YET = ("NNS509", "NNS512", "NNS516")

_MESH_509_512 = '''    # mesh micro-batch whose bucket can't split over the data axis:
    # pad slots burn device time on every window (batch=6 over
    # data:4 — and the implied bucket list is just (6,))
    (f"appsrc caps={GOOD_CAPS} ! queue ! tensor_filter "
     "framework=jax-xla model=/nonexistent/model.pkl mesh=data:4 "
     "batch=6 ! tensor_sink", {"NNS509"}),
    # pool-level NNS509: a share-model pool whose cross-pipeline
    # window can't split over the mesh data axis pads on EVERY
    # coalesced window, for every sharer at once
    (f"appsrc caps={GOOD_CAPS} ! queue ! tensor_filter "
     "framework=jax-xla model=/nonexistent/model.pkl mesh=data:4 "
     "batch=6 share-model=true ! tensor_sink", {"NNS512"}),
'''

_SPLIT_516 = '''    # pipeline split: two declared stage subsets sharing chips —
    # the stages contend and per-stage attribution is unreliable
    (f"appsrc caps={GOOD_CAPS} ! queue ! tensor_filter name=f1 "
     "framework=jax-xla model=/nonexistent/model.pkl mesh=data:4 "
     "devices=0-3 batch=4 share-model=true ! tensor_sink "
     f"appsrc name=b caps={GOOD_CAPS} ! queue ! tensor_filter name=f2 "
     "framework=jax-xla model=/nonexistent/model.pkl mesh=data:4 "
     "devices=2-5 batch=4 share-model=true ! tensor_sink name=s2",
     {"NNS516"}),
    # cascade offload branch reaching the heavy stage only through a
    # host-only converter (+ the heavy stage missing share-model)
    (f"appsrc caps={GOOD_CAPS} ! tensor_if name=i operator=ge "
     "supplied-value=1 offload=then "
     "i.src_then ! tensor_converter ! tensor_filter name=hv "
     "framework=jax-xla model=/nonexistent/model.pkl mesh=data:4 "
     "devices=4-7 ! tensor_sink "
     "i.src_else ! tensor_sink name=s2", {"NNS516"}),
    # offload grammar: the branch name must be then/else
    (f"appsrc caps={GOOD_CAPS} ! tensor_if name=i offload=both ! "
     "tensor_sink i.src_else ! tensor_sink name=s2", {"NNS516"}),
'''

replay("test_analyze.py", globals(), subs=(
    (_MESH_509_512, ""),
    (_SPLIT_516, ""),
    ("    assert covered == set(CODES)\n",
     "    assert covered == set(CODES) - set(NOT_YET)\n"),
    # the port's corpus: chip_smoke.py's literals and the port's docs
    ('default_corpus(os.path.join(REPO, "examples"))',
     'default_corpus(os.path.join(REPO, "chip_smoke.py"))'),
    # the tests that start or parse a pipeline themselves do so on the CPU
    ("    parse_launch,\n    register_element,\n)\n",
     "    register_element,\n)\n"
     "from functools import partial as _partial\n"
     "from nnstreamer_tpu.runtime import parse_launch as _parse_launch\n"
     "parse_launch = _partial(_parse_launch, device='cpu')\n"),
    ("from nnstreamer_tpu.filters.jax_xla import register_model, \\\n"
     "        unregister_model",
     "from nnstreamer_tpu.filters import register_model, unregister_model"),
    # a torch model: torch tensors have no astype
    ('lambda x: x.astype("float32") + 1', "lambda x: x.float() + 1"),
), leave_out=(
    "test_nns516_faces", "test_nns516_negative_cases",
    "test_nns512_pool_divisibility_and_conflicts",
    "test_nns509_divisible_and_unknown_axis_are_clean",
))
