"""flcheck for the port: PyTorch-aware analysis of the fast path.

Two layers, one CLI (``scripts/flcheck_torch.py``):

* :mod:`repro_torch.analysis.lint` runs Python-AST rules over the source
  tree (host syncs in hot functions, Python control flow on tensors inside
  ``torch.func`` transforms, config-validation/doc coverage); the rule
  catalog lives in :mod:`repro_torch.analysis.rules`.
* :mod:`repro_torch.analysis.contracts` (``--contracts``), the twin of the
  reference's compiled-program contracts: one build of each round program
  a bucket and none across rounds, no host transfer inside a program (on
  a card: the fused round captured as one CUDA graph a bucket, replayed
  without a sync), one dispatch and one host sync a fused round, and the
  FLOPs / bytes ratchet against ``scripts/roofline_baseline_torch.json``.

The lint layer is pure stdlib: the script loads it without importing the
package (and so without torch); the contracts layer imports torch and is
imported only where it runs.
"""
from repro_torch.analysis.lint import Finding, lint_paths
from repro_torch.analysis.rules import RULES
