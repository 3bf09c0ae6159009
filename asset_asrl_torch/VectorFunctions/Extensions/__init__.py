"""VectorFunctions extensions (reference
`asset_asrl/VectorFunctions/Extensions/`)."""

from .DerivChecker import FDDerivChecker
