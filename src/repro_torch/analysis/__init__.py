"""flcheck for the port: PyTorch-aware static analysis of the fast path.

One layer, one CLI (``scripts/flcheck_torch.py``):
:mod:`repro_torch.analysis.lint` runs Python-AST rules over the source
tree (host syncs in hot functions, Python control flow on tensors inside
``torch.func`` transforms, config-validation/doc coverage); the rule
catalog lives in :mod:`repro_torch.analysis.rules`.

The reference's second layer, compiled-program contracts
(``repro.analysis.contracts``: one program a bucket, no recompiles, no
host transfers in the round), has no twin until the port captures its
round as a CUDA graph a bucket (ROADMAP M5.3).

The lint layer is pure stdlib: the script loads it without importing the
package (and so without torch).
"""
from repro_torch.analysis.lint import Finding, lint_paths
from repro_torch.analysis.rules import RULES
