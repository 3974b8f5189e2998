from .generate import (GenerationConfig, generate_with_kv_cache,
                       sample_for_reinforce, sequence_mask)
from .latent import (centroid_walk, element_anchored_blend, element_jaccard_neighbors,
                     interpolation_sweep, lerp, pca_components, pca_walk, perturb, slerp)
from .latent_analyzer import LatentCache, LatentSpaceAnalyzer
from .candidate_generator import CandidateGenerator
from .discovery import Candidate, SuperconductorDiscoveryPipeline
