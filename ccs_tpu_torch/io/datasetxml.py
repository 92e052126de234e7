"""consensusreadset.xml writer (PacBio DataSet XML, minimal valid subset).

The reference accepts ``out.consensusreadset.xml`` as the output positional
(index.md:55-58), writing the BAM + .pbi alongside and an XML wrapper that
SMRT Link consumes.
"""

from __future__ import annotations

import os
import uuid
import xml.sax.saxutils as sx
from datetime import datetime, timezone


def write_consensusreadset(xml_path: str, bam_path: str, n_records: int,
                           total_length: int, name: str = "ccs_tpu") -> None:
    created = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
    ds_uuid = str(uuid.uuid4())
    bam_rel = os.path.basename(bam_path)
    xml = f"""<?xml version="1.0" encoding="utf-8"?>
<pbds:ConsensusReadSet
    xmlns:pbbase="http://pacificbiosciences.com/PacBioBaseDataModel.xsd"
    xmlns:pbds="http://pacificbiosciences.com/PacBioDatasets.xsd"
    CreatedAt="{created}" MetaType="PacBio.DataSet.ConsensusReadSet"
    Name="{sx.escape(name)}" Tags="ccs" TimeStampedName="ccs_tpu-{created}"
    UniqueId="{ds_uuid}" Version="4.0.0">
  <pbbase:ExternalResources>
    <pbbase:ExternalResource MetaType="PacBio.ConsensusReadFile.ConsensusReadBamFile"
        ResourceId="{sx.escape(bam_rel)}" UniqueId="{uuid.uuid4()}">
      <pbbase:FileIndices>
        <pbbase:FileIndex MetaType="PacBio.Index.PacBioIndex"
            ResourceId="{sx.escape(bam_rel)}.pbi" UniqueId="{uuid.uuid4()}"/>
      </pbbase:FileIndices>
    </pbbase:ExternalResource>
  </pbbase:ExternalResources>
  <pbds:DataSetMetadata>
    <pbds:TotalLength>{total_length}</pbds:TotalLength>
    <pbds:NumRecords>{n_records}</pbds:NumRecords>
  </pbds:DataSetMetadata>
</pbds:ConsensusReadSet>
"""
    with open(xml_path, "w") as fh:
        fh.write(xml)


def write_subreadset(xml_path: str, bam_path: str, holes,
                     n_records: int = 0, total_length: int = 0,
                     name: str = "ccs_tpu subsampled CLR") -> None:
    """SubreadSet XML referencing the ORIGINAL subreads.bam restricted to a
    ZMW whitelist — the --subsample-clr-perc/-file output (C17,
    reference docs, changelog.md:28,37: 'store a percentage of
    productive ZMWs as subreads (stores XML and PBI)'). No read data is
    copied; the filter selects the sampled holes."""
    created = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
    ds_uuid = str(uuid.uuid4())
    bam_rel = os.path.basename(bam_path)
    hole_list = ",".join(str(int(h)) for h in holes)
    xml = f"""<?xml version="1.0" encoding="utf-8"?>
<pbds:SubreadSet
    xmlns:pbbase="http://pacificbiosciences.com/PacBioBaseDataModel.xsd"
    xmlns:pbds="http://pacificbiosciences.com/PacBioDatasets.xsd"
    CreatedAt="{created}" MetaType="PacBio.DataSet.SubreadSet"
    Name="{sx.escape(name)}" Tags="subreads,subsample"
    TimeStampedName="ccs_tpu-clr-{created}"
    UniqueId="{ds_uuid}" Version="4.0.0">
  <pbbase:ExternalResources>
    <pbbase:ExternalResource MetaType="PacBio.SubreadFile.SubreadBamFile"
        ResourceId="{sx.escape(bam_rel)}" UniqueId="{uuid.uuid4()}">
      <pbbase:FileIndices>
        <pbbase:FileIndex MetaType="PacBio.Index.PacBioIndex"
            ResourceId="{sx.escape(bam_rel)}.pbi" UniqueId="{uuid.uuid4()}"/>
      </pbbase:FileIndices>
    </pbbase:ExternalResource>
  </pbbase:ExternalResources>
  <pbds:Filters>
    <pbds:Filter>
      <pbbase:Properties>
        <pbbase:Property Name="zm" Operator="==" Value="[{hole_list}]"/>
      </pbbase:Properties>
    </pbds:Filter>
  </pbds:Filters>
  <pbds:DataSetMetadata>
    <pbds:TotalLength>{total_length}</pbds:TotalLength>
    <pbds:NumRecords>{n_records}</pbds:NumRecords>
  </pbds:DataSetMetadata>
</pbds:SubreadSet>
"""
    with open(xml_path, "w") as fh:
        fh.write(xml)
