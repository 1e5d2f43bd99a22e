"""Segmentation-dataset id -> organ/target term lists (a copy of
``u2tokenizer_tpu/data/dataset_info.py``).

Counterpart of src/dataset/dataset_info.py:2-96: the M3D-Seg release indexes
its 25 public CT segmentation sources by zero-padded ids, each with the label
vocabulary of that source (class index i = terms[i]). The entries below cover
the sources by their public label sets; ids mirror the M3D-Seg layout.
"""

dataset_info = {
    # LiTS-style liver
    "0000": ["liver"],
    # head & neck OAR set (SegRap-style)
    "0001": [
        "carotid artery left", "carotid artery right", "arytenoid",
        "bone mandible", "brainstem", "buccal mucosa", "oral cavity",
        "cochlea left", "cochlea right", "cricopharyngeal inlet",
        "cervical esophagus", "anterior eyeball left", "anterior eyeball right",
        "posterior eyeball left", "posterior eyeball right",
        "lacrimal gland left", "lacrimal gland right",
        "submandibular gland left", "submandibular gland right", "thyroid",
        "larynx glottis", "larynx supraglottic", "lips", "optic chiasm",
        "optic nerve left", "optic nerve right", "parotid gland left",
        "parotid gland right", "pituitary gland", "spinal cord",
    ],
    # AMOS-style abdominal multi-organ
    "0002": [
        "spleen", "right kidney", "left kidney", "gall bladder", "esophagus",
        "liver", "stomach", "aorta", "postcava", "pancreas",
        "right adrenal gland", "left adrenal gland", "duodenum", "bladder",
        "prostate or uterus",
    ],
    "0003": ["liver", "kidney", "spleen", "pancreas"],
    "0004": ["kidney", "kidney tumor", "kidney cyst"],
    "0005": ["renal vein", "kidney", "renal artery", "tumor"],
    "0006": ["kidney", "kidney tumor"],
    # BTCV-style
    "0007": [
        "spleen", "right kidney", "left kidney", "gallbladder", "esophagus",
        "liver", "stomach", "aorta", "inferior vena cava",
        "portal vein and splenic vein", "pancreas", "right adrenal gland",
        "left adrenal gland",
    ],
    "0008": ["pancreas"],
    "0010": ["liver", "liver tumor"],
    "0011": ["lung", "colon cancer"],
    "0012": ["lung nodule"],
    "0013": ["lung", "covid-19 infection"],
    "0014": ["esophagus", "esophageal tumor"],
    "0015": ["heart", "left atrium"],
    "0016": ["spleen"],
    "0017": ["hepatic vessel", "liver tumor"],
    "0018": ["colon", "colon tumor"],
    "0019": ["whole body: bones"],
    "0020": [
        "adrenal gland", "aorta", "bladder", "bone", "brain", "duodenum",
        "esophagus", "gallbladder", "heart", "intestine", "kidney",
        "left adrenal gland", "left kidney", "left lung", "liver", "lung",
        "pancreas", "right adrenal gland", "right kidney", "right lung",
        "spleen", "stomach",
    ],
    "0021": ["vertebrae"],
    "0022": ["rib"],
    "0023": ["whole heart substructures"],
    "0024": ["abdominal organs"],
    "0025": ["thoracic organs"],
}
