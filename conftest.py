"""Points the reference's oracle binding at a built C++ oracle.

`tpz.oracle` loads `cpp/libtpz_oracle.so`, or the library that
`TPZ_ORACLE_LIB` names, and the test command builds neither. When the
variable is unset and that file is missing, the library that
`tpz_torch.oracle.build()` makes from the same `cpp/` sources (under a
lock, keyed on its inputs, into `build/oracle/`) stands in for it, so the
reference's suites that need the oracle run instead of failing or
skipping.
"""

import os


def pytest_configure(config):
    if os.environ.get("TPZ_ORACLE_LIB"):
        return
    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.exists(os.path.join(here, "cpp", "libtpz_oracle.so")):
        return
    from tpz_torch import oracle

    os.environ["TPZ_ORACLE_LIB"] = oracle.build()
