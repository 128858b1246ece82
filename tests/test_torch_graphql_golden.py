"""The port's GraphQL layer against the reference's GraphQL goldens.

tests/test_ref_golden_graphql.py (the e2e response goldens over both
fixtures and the resolve translation-equivalence cases),
test_ref_golden_graphql_auth.py and test_ref_golden_graphql_mut.py, each
case run on both packages by the runner of tests/test_torch_graphql.py:
once as written and once with `dgraph_tpu` rebound to
`dgraph_tpu_torch` (in `ref_golden_graphql/mutation_support.py` too),
each side meeting the golden's own assertions, and every answer of
`GraphQLServer.execute` and `Server.query` equal, byte for byte. A case
the reference tracks as a known gap (strict `xfail`) stays `xfail`:
both packages must fail it after the same answers.
"""

import pytest

from test_torch_graphql import cases, run_both, runner  # noqa: F401 - fixture

GOLDEN_CASES = (
    cases("test_ref_golden_graphql") + cases("test_ref_golden_graphql_auth")
    + cases("test_ref_golden_graphql_mut")
)


@pytest.mark.parametrize("case", GOLDEN_CASES)
def test_golden_on_both_packages(case, runner, tmp_path, request):  # noqa: F811
    """The golden case passes (or fails, if tracked) on both packages,
    with equal answers."""
    run_both(runner, case, tmp_path, request)
