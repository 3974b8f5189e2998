from .topology import TopologyAnalyzer
