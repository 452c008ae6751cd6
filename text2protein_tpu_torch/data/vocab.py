"""Residue vocabulary (the constants of text2protein_tpu/data/vocab.py that
the port's data pipeline uses): 21 classes (20 amino acids + UNK = X = 20),
padding id 21. The table of non-standard residue names waits for the PDB
reader."""

THREE_TO_ONE = {
    'CYS': 'C', 'ASP': 'D', 'SER': 'S', 'GLN': 'Q', 'LYS': 'K',
    'ILE': 'I', 'PRO': 'P', 'THR': 'T', 'PHE': 'F', 'ASN': 'N',
    'GLY': 'G', 'HIS': 'H', 'LEU': 'L', 'ARG': 'R', 'TRP': 'W',
    'ALA': 'A', 'VAL': 'V', 'GLU': 'E', 'TYR': 'Y', 'MET': 'M', 'UNK': 'X',
}

ONE_TO_THREE = {v: k for k, v in THREE_TO_ONE.items()}

LETTER_TO_NUM = {
    'C': 4, 'D': 3, 'S': 15, 'Q': 5, 'K': 11, 'I': 9,
    'P': 14, 'T': 16, 'F': 13, 'A': 0, 'G': 7, 'H': 8,
    'E': 6, 'L': 10, 'R': 1, 'W': 17, 'V': 19,
    'N': 2, 'Y': 18, 'M': 12, 'X': 20,
}

NUM_TO_LETTER = {v: k for k, v in LETTER_TO_NUM.items()}

AA_PAD_ID = 21  # padding class id
AA_PAD_CHAR = "_"
